"""Command-line drivers of the port: `python -m dvg_tpu_torch.cli.generate`
mirrors `dvg_tpu/cli/generate.py` (the reference's generate_frames.py)."""
