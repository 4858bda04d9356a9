"""tulip_tpu_torch: the PyTorch / CUDA port of ``tulip_tpu``.

The JAX package ``tulip_tpu`` is the reference; this package computes the
same functions in PyTorch, with every Pallas kernel of the ported path
replaced by a CUDA kernel written for Hopper (``csrc/``).  It imports
``torch`` and never ``jax``, and nothing of ``tulip_tpu``: what it needs of
that package's jax-free modules it holds as its own copies, which the tests
keep equal to the originals.

- ``tulip_tpu_torch.main_lidar_upsampling``  the command line (``python3 -m
  tulip_tpu_torch.main_lidar_upsampling``, the flags of bash_scripts/*.sh):
  train, checkpoint, resume, ``--eval``; ``--device cuda`` (default) or
  ``cpu``; data-parallel under ``torchrun --nproc_per_node=N``.
- ``tulip_tpu_torch.config``    the argument parser and the static model
  config (a copy of ``tulip_tpu/config.py``; ``--attn_impl`` is accepted
  and ignored).
- ``tulip_tpu_torch.data``      loaders, transforms, the durlar / kitti /
  carla dataset builders, the sharded sampler and the prefetching loader
  (numpy-only copies of ``tulip_tpu/data``, without the native reader).
- ``tulip_tpu_torch.models``    the TULIP Swin U-Net as ``nn.Module``s whose
  parameter names are the reference state-dict keys.
- ``tulip_tpu_torch.ops``       kernel wrappers: a CPU tensor takes the plain
  PyTorch version, a CUDA tensor launches the kernel (``ops/build.py``
  compiles ``csrc/*.cu`` with ``nvcc`` on first use): ``window_msa`` (and
  its grouped and natural-layout entries), ``mlp``, ``attn_core``, ``ln``,
  ``chamfer``, ``reduce``.
- ``tulip_tpu_torch.train``     the train step (AdamW over fp32 master
  weights, bf16 compute) and train_one_epoch.
- ``tulip_tpu_torch.eval``      the evaluate / MCdrop engines, device
  projections and metrics (chamfer, voxel counts).
- ``tulip_tpu_torch.parallel``  grid rolls and circular padding; launcher
  discovery, the torch.distributed group and the replicas (``mesh``); the
  rank, the metric reductions and the bucketed gradient average
  (``dist``).
- ``tulip_tpu_torch.utils``     checkpoints (save / load / resume, the JAX
  package's native file included) and the weight exchange with the JAX
  package, the TensorBoard / PLY writers, the LR schedule and the metric
  logger.
"""

__version__ = "0.1.0"
