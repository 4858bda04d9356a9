"""tulip_tpu_torch: the PyTorch / CUDA port of ``tulip_tpu``.

The JAX package ``tulip_tpu`` is the reference; this package computes the
same functions in PyTorch, with every Pallas kernel of the ported path
replaced by a CUDA kernel written for Hopper (``csrc/``).  It imports
``torch`` and never ``jax``.

- ``tulip_tpu_torch.config``    the static model config, re-exported from
  ``tulip_tpu.config`` (pure Python).
- ``tulip_tpu_torch.models``    the TULIP Swin U-Net as ``nn.Module``s whose
  parameter names are the reference state-dict keys.
- ``tulip_tpu_torch.ops``       kernel wrappers: a CPU tensor takes the plain
  PyTorch version, a CUDA tensor launches the kernel (``ops/build.py``
  compiles ``csrc/*.cu`` with ``nvcc`` on first use).
- ``tulip_tpu_torch.train``     the train step (AdamW over fp32 master
  weights, bf16 compute) and train_one_epoch.
- ``tulip_tpu_torch.eval``      the evaluate / MCdrop engines, device
  projections and metrics (chamfer, voxel counts).
- ``tulip_tpu_torch.parallel``  grid rolls and circular padding; the
  single-process metric reduction.
- ``tulip_tpu_torch.utils``     weight exchange with the JAX package, the
  TensorBoard / PLY writers, the LR schedule and the metric logger.
"""

__version__ = "0.1.0"
