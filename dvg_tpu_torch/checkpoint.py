"""Read and write the `dvg_tpu` checkpoint format (`model.ckpt`) without
JAX, flax or msgpack (counterpart of `dvg_tpu/train/checkpoint.py`).

The file is one msgpack map `{config, opt_states, params, stats, step}`:
`config` is the DVGConfig as a JSON string; the other entries are flax
state dicts, in which every list became a map keyed "0", "1", …, and every
array a numpy extension value (`_msgpack`). The JAX package writes its
maps with sorted keys.

    cfg, model = load_model("runs/mnist", device="cuda")
    cfg, state_dict, payload = load_checkpoint("runs/mnist/model.ckpt")
    blob = read_checkpoint_bytes_synced("runs/mnist")   # every rank
    save_checkpoint("out", cfg, model, payload)
    save_train_state("out", cfg, state)
    saved_cfg, state = load_train_state("out", run_cfg, device="cuda")

`load_checkpoint` maps params and stats to a `DVGModel` state_dict through
`convert.params_from_jax`; `save_checkpoint` maps a model back through
`convert.params_to_jax` and carries `opt_states` and `step` of a loaded
payload through untouched, so a dvg_tpu training run can resume from it.
Without a payload it writes empty optimizer states and step 0: a file
`dvg_tpu` generation reads, but not one its training can resume from.

`save_train_state` writes a whole TrainState of the port's trainer: the
four optimizer groups' state in optax's layout (`train.optim`) and the
step, so `dvg_tpu.train.load_checkpoint(path, target_state=…)` resumes it;
`load_train_state` resumes the port from a file either package wrote,
under the run's config, as `dvg_tpu`'s `load_checkpoint(target_state=…)`
does.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dvg_tpu_torch import _msgpack
from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.convert import _lists, params_from_jax, params_to_jax
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.parallel.collectives import broadcast_, world_size
from dvg_tpu_torch.train.step import TrainState, train_state

CKPT_NAME = "model.ckpt"
PAYLOAD_KEYS = ("config", "opt_states", "params", "stats", "step")


def _file(path: str) -> str:
    return os.path.join(path, CKPT_NAME) if os.path.isdir(path) else path


def _state_dict(tree: Any) -> Any:
    """The inverse of `_lists`, with keys sorted as the JAX writer sorts
    them."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _state_dict(tree[k]) for k in sorted(tree)}
    return tree


def read_checkpoint_bytes_synced(path: str, group=None) -> bytes:
    """The checkpoint file's bytes, identical on every rank of `group` (the
    default group for None; counterpart of dvg_tpu/train/checkpoint.py:
    102-148). Checkpoints are written by the coordinator only, so a peer's
    disk may hold a missing or stale file: rank 0 reads it and broadcasts
    a header [err, size_hi, size_lo] (uint32 words, carried in an int64
    tensor), then the bytes. A failed read on rank 0 sets err, so every
    peer raises instead of waiting in the collective. Without a process
    group of more than one rank, a plain read."""
    path = _file(path)
    if world_size(group) == 1:
        with open(path, "rb") as f:
            return f.read()
    blob, err = b"", None
    if dist.get_rank(group) == 0:
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as e:
            err = e
    src = 0 if group is None else dist.get_global_rank(group, 0)
    header = torch.tensor([int(err is not None), len(blob) >> 32,
                           len(blob) & 0xFFFFFFFF], dtype=torch.int64)
    broadcast_([header], src, group)
    if int(header[0]):
        if err is not None:
            raise err
        raise RuntimeError(f"rank 0 failed to read checkpoint {path!r}; "
                           "this rank stops with it")
    size = (int(header[1]) << 32) | int(header[2])
    data = (torch.frombuffer(bytearray(blob), dtype=torch.uint8) if blob
            else torch.empty((size,), dtype=torch.uint8))
    broadcast_([data], src, group)
    return data.numpy().tobytes()


def _synced(synced: Optional[bool]) -> bool:
    """None means: synced when a process group of more than one rank is
    up."""
    return world_size() > 1 if synced is None else synced


def _payload(path: str, synced: Optional[bool] = None
             ) -> Tuple[DVGConfig, Dict[str, Any]]:
    if _synced(synced):
        blob = read_checkpoint_bytes_synced(path)
    else:
        with open(_file(path), "rb") as f:
            blob = f.read()
    payload = _msgpack.unpackb(blob)
    if not isinstance(payload, dict) or set(payload) != set(PAYLOAD_KEYS):
        keys = sorted(payload) if isinstance(payload, dict) else payload
        raise ValueError(f"{path}: not a dvg_tpu checkpoint (top-level "
                         f"entries {keys}, want {list(PAYLOAD_KEYS)})")
    return DVGConfig.from_dict(json.loads(payload["config"])), payload


def load_checkpoint(path: str, synced: Optional[bool] = None
                    ) -> Tuple[DVGConfig, Dict[str, torch.Tensor],
                               Dict[str, Any]]:
    """`path` (a file, or a directory holding model.ckpt) → (its config, a
    state_dict for `DVGModel(cfg)` on the CPU, the decoded payload).
    `synced` reads it by `read_checkpoint_bytes_synced`, which every rank
    must then call; None means when a process group of more than one rank
    is up (likewise for the loaders below)."""
    cfg, payload = _payload(path, synced)
    sd = params_from_jax(_lists(payload["params"]), _lists(payload["stats"]),
                         cfg)
    return cfg, sd, payload


def load_model(path: str, device="cuda", synced: Optional[bool] = None
               ) -> Tuple[DVGConfig, DVGModel]:
    """(config, DVGModel with the checkpoint's weights on `device`)."""
    cfg, sd, _ = load_checkpoint(path, synced)
    model = DVGModel(cfg, device="cpu")
    model.load_state_dict(sd)
    return cfg, model.to(device)


def load_train_state(path: str, cfg: Optional[DVGConfig] = None,
                     device="cuda", synced: Optional[bool] = None
                     ) -> Tuple[DVGConfig, TrainState]:
    """(the file's config, a TrainState on `device`). With `cfg`, the run's
    config, the model and its optimizers are built from `cfg`, as
    `dvg_tpu`'s training CLI builds them from its command line, and the
    file provides only its leaves: parameters and BN statistics, Adam
    moments, update counts and the step; its learning rates, beta1, GP
    schedule and updates per batch are the run's. Without `cfg`, the
    file's config stands in for it. A file of another backbone raises
    ValueError, and leaves of other shapes raise `load_state_dict`'s
    RuntimeError, naming the leaf. A file without optimizer state (an
    eval checkpoint) starts fresh optimizers at its step."""
    saved_cfg, payload = _payload(path, synced)
    cfg = cfg or saved_cfg
    params, stats = _lists(payload["params"]), _lists(payload["stats"])
    model = DVGModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, stats, cfg))
    state = train_state(model.to(device), cfg,
                        step=int(np.asarray(payload["step"])))
    if payload["opt_states"]:
        state.opts.load_jax(_lists(payload["opt_states"]), stats, cfg)
    return saved_cfg, state


def save_train_state(path: str, cfg: DVGConfig, state: TrainState) -> str:
    """Write a TrainState in the dvg_tpu format;
    `path` as for `save_checkpoint`. Returns the file written."""
    return save_checkpoint(path, cfg, state.model, {
        "opt_states": _state_dict(state.opts.to_jax(state.model, cfg)),
        "step": np.asarray(state.step, np.int32)})


def save_checkpoint(path: str, cfg: DVGConfig, model: DVGModel,
                    payload: Optional[Dict[str, Any]] = None) -> str:
    """Write `model`'s weights and `cfg` in the dvg_tpu format. `path` is a
    directory (model.ckpt is written inside it) unless it ends in .ckpt or
    .msgpack, as in the JAX package. Returns the file written."""
    is_file = (not path.endswith(os.sep) and not os.path.isdir(path)
               and os.path.splitext(path)[1] in (".ckpt", ".msgpack"))
    if is_file:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    else:
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, CKPT_NAME)
    params, stats = params_to_jax(model.state_dict(), cfg)
    blob = _msgpack.packb({
        "config": json.dumps(cfg.to_dict()),
        "opt_states": payload["opt_states"] if payload else {},
        "params": _state_dict(params),
        "stats": _state_dict(stats),
        "step": payload["step"] if payload else np.asarray(0, np.int32),
    })
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return path
