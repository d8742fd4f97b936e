"""dvg_tpu_torch: the PyTorch / CUDA port of dvg_tpu for NVIDIA Hopper (H100).

The JAX package `dvg_tpu` beside it is the reference this port is held
against; the port imports torch and never jax, nor anything of `dvg_tpu`.
Its layout follows `dvg_tpu`'s, so each module's counterpart sits at the
same path. Entry points run on the card (`device="cuda"`) unless the caller
asks for the CPU, and raise where there is no card. Public tensors keep the
JAX package's layouts: NHWC images, (T, B, H, W, C) clips and
(S, n_free, B) metrics.

Ported so far, for the four backbones DCGAN-64, DCGAN-128, VGG-64 and
VGG-128 (`models/registry.py`): generation (`generate.rollout.
make_rollout_fns`: posterior, diverse, diverse_metrics, the exact re-rolls,
plot_samples and gp_trigger) with both hand-written CUDA metric kernels
(`ops/ssim_cuda.py`, `csrc/ssim_cyclic.cu`) and the Finn and kernel-free
metric routes (`ops/ssim.py`), the `dvg_tpu` checkpoint format
(`checkpoint.py`), the datasets and loader (`data/`), the eval CLI
(`python -m dvg_tpu_torch.cli.generate`) with its PNG/GIF writers, logging
and profiling (`utils/`), none of which needs PIL or imageio,
training (`train/`, `python -m dvg_tpu_torch.cli.train`),
the reference `.pth` importer (`train/import_torch.py`, `python -m
dvg_tpu_torch.train.import_torch`), the dataset converters
(`data/convert.py`: BAIR TFRecords, KTH/UCF videos, metadata), the
native frame decoder (`runtime/fastload.py`, libpng/libjpeg, built at
first use where those are installed), and distribution over
`torch.distributed` (`parallel/`: data-parallel training with global-batch
BatchNorm, the sample- and (sample, data)-sharded diverse eval, both
CLIs' mesh flags, coordinator-only writes), serving export (`serve/`:
`torch.export` artifacts of posterior, diverse_metrics and gp_trigger, K1
and K2 as custom ops, sharded artifacts; `python -m
dvg_tpu_torch.serve.export`), the GP library API on the raw parameters
(`models/gp.py`: rbf_cross, kernel_diag, predictive_variance,
posterior_full_cov, rsample; DVGModel's gp_* wrappers), the training soak
(`python -m dvg_tpu_torch.cli.soak`, the counterpart of scripts/soak.py),
and the modules no path calls: the gru, rnn and gaussian_lstm predictors,
VGG's Gaussian encoder and the classifiers (`models/classifiers.py`). The
port does all that `dvg_tpu` does, with one result open: the soak it
trains on the card scores below the JAX package's TPU run of the same
recipe (F2 in ROADMAP.md queue 3).
"""

__version__ = "0.1.0"

from dvg_tpu_torch.config import DVGConfig, resolve_device  # noqa: F401,E402
