"""Serving export of the port (counterpart of `dvg_tpu/serve`):
`export_serving` writes a checkpoint's posterior, diverse_metrics or
gp_trigger as a self-contained `torch.export` program, and `load_serving`
runs one without the port's model or generation code.

Both resolve on first use, so `python -m dvg_tpu_torch.serve.export` runs
the module once, as its main."""

__all__ = ["export_serving", "load_serving"]


def __getattr__(name: str):
    if name in __all__:
        from dvg_tpu_torch.serve import export
        return getattr(export, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
