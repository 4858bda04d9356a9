"""Config system: argparse CLI (flag-compatible with the reference,
tulip/main_lidar_upsampling.py:34-140) mapped onto a typed dataclass.

The port's own copy of tulip_tpu/config.py: the same flags, names, types
and defaults, and the same static model configuration.  The differences
are the ``--device`` and ``--attn_impl`` help strings and
:func:`model_config_from_args`, which has no backend to ask.

The bash_scripts/ workflows must run unchanged, so every reference flag is
accepted here with identical names, types and defaults.  Internally the
trainer/evaluator consume :class:`Args` (a plain namespace-like dataclass)
plus :func:`model_config`, which resolves all *static* model shape decisions
at config time (per-stage grids, per-stage window sizes including the
H-smaller-than-window fallback that the reference resolves by mutating module
state at runtime, tulip/model/tulip.py:284-287).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence, Tuple


def get_args_parser() -> argparse.ArgumentParser:
    """Exact public flag surface of the reference CLI
    (tulip/main_lidar_upsampling.py:34-140)."""
    parser = argparse.ArgumentParser('TULIP training/eval', add_help=False)

    # Model parameters
    parser.add_argument('--model_select', default='mae', type=str,
                        choices=['tulip_base', 'tulip_large'])
    parser.add_argument('--window_size', nargs="+", type=int,
                        help='size of window partition')
    parser.add_argument('--remove_mask_token', action="store_true",
                        help="Remove mask token in the encoder")
    parser.add_argument('--patch_size', nargs="+", type=int,
                        help='image size, given in format h w')
    parser.add_argument('--pixel_shuffle', action='store_true',
                        help='pixel shuffle upsampling head')
    parser.add_argument('--circular_padding', action='store_true',
                        help='circular padding, kernel size is 1, 8 and stride is 1, 4')
    parser.add_argument('--patch_unmerging', action='store_true',
                        help='reverse operation of patch merging')
    parser.add_argument('--swin_v2', action='store_true',
                        help='use swin_v2 block')

    # Optimizer parameters
    parser.add_argument('--weight_decay', type=float, default=0.05)
    parser.add_argument('--lr', type=float, default=None, metavar='LR')
    parser.add_argument('--blr', type=float, default=1e-3, metavar='LR')
    parser.add_argument('--min_lr', type=float, default=0., metavar='LR')
    parser.add_argument('--warmup_epochs', type=int, default=40, metavar='N')

    # Augmentation parameters
    parser.add_argument('--roll', action="store_true",
                        help='random roll range map in vertical direction')

    # Dataset parameters
    parser.add_argument('--dataset_select', default='durlar', type=str,
                        choices=['durlar', 'carla', 'kitti'])
    parser.add_argument('--img_size_low_res', nargs="+", type=int)
    parser.add_argument('--img_size_high_res', nargs="+", type=int)
    parser.add_argument('--in_chans', type=int, default=1)
    parser.add_argument('--data_path_low_res', default=None, type=str)
    parser.add_argument('--data_path_high_res', default=None, type=str)
    parser.add_argument('--save_pcd', action="store_true")
    parser.add_argument('--log_transform', action="store_true")
    parser.add_argument('--keep_close_scan', action="store_true")
    parser.add_argument('--keep_far_scan', action="store_true")

    # Training parameters
    parser.add_argument('--batch_size', default=64, type=int)
    parser.add_argument('--epochs', default=400, type=int)
    parser.add_argument('--accum_iter', default=1, type=int)
    parser.add_argument('--output_dir', default='./output_dir')
    parser.add_argument('--log_dir', default='./output_dir')
    parser.add_argument('--device', default='cuda',
                        help='cuda (the default; raises if there is no GPU) '
                             'or cpu; nothing falls back to the CPU by itself')
    parser.add_argument('--seed', default=0, type=int)
    parser.add_argument('--resume', default='')
    parser.add_argument('--start_epoch', default=0, type=int, metavar='N')
    parser.add_argument('--save_frequency', default=100, type=int)
    parser.add_argument('--num_workers', default=10, type=int)
    parser.add_argument('--pin_mem', action='store_true')
    parser.add_argument('--no_pin_mem', action='store_false', dest='pin_mem')
    parser.set_defaults(pin_mem=True)

    # distributed training parameters
    parser.add_argument('--world_size', default=1, type=int)
    parser.add_argument('--local_rank', default=-1, type=int)
    parser.add_argument('--dist_on_itp', action='store_true')
    parser.add_argument('--dist_url', default='env://')

    # Logger parameters
    parser.add_argument('--wandb_disabled', action='store_true')
    parser.add_argument('--entity', type=str, default="biyang")
    parser.add_argument('--project_name', type=str, default="Ouster_MAE")
    parser.add_argument('--run_name', type=str, default=None)

    # Evaluation parameters
    parser.add_argument('--eval', action='store_true')
    parser.add_argument('--mc_drop', action='store_true')
    parser.add_argument('--num_mcdropout_iterations', type=int, default=50)
    parser.add_argument('--noise_threshold', type=float, default=0.03)
    parser.add_argument('--grid_size', type=float, default=0.1)

    # extensions of the JAX package (not in the reference; all optional)
    parser.add_argument('--precision', default='bf16', type=str,
                        choices=['bf16', 'fp32'],
                        help='compute precision of the model in training')
    parser.add_argument('--eval_precision', default='fp32', type=str,
                        choices=['bf16', 'fp32'],
                        help='compute precision at evaluation time')
    parser.add_argument('--attn_impl', default='pallas', type=str,
                        choices=['xla', 'grouped', 'pallas'],
                        help='accepted for compatibility and ignored: the '
                             'port has one window-attention implementation, '
                             'which takes its CUDA kernel for a CUDA tensor '
                             'and its plain version for a CPU tensor')
    parser.add_argument('--chamfer_impl', default='auto', type=str,
                        choices=['auto', 'xla', 'pallas', 'pallas_h'],
                        help='chamfer-distance implementation (pallas = '
                             'brute force, pallas_h = hierarchical exact '
                             'tile skipping, xla = plain tensor ops)')
    parser.add_argument('--mesh_shape', nargs='+', type=int, default=None,
                        help='device mesh of the JAX package; the port lays '
                             'the N ranks of its group out as [dp, sp] = '
                             '[N / sp_degree, sp_degree], so N or '
                             'N/sp_degree sp_degree (any other shape '
                             'raises)')
    parser.add_argument('--sp_degree', default=1, type=int,
                        help='W-axis sequence parallel: the range image is '
                             'cut along W over sp_degree ranks of each data '
                             'index, whose shards meet in halo exchanges '
                             '(rank = d*sp + s); clamped to the geometry\'s '
                             'cap (every stage keeps 2 window columns a '
                             'shard: 4 for TULIP-base at 32x2048); one that '
                             'does not divide the world size raises')
    parser.add_argument('--depth_scale_loss', action='store_true',
                        help='reference references this flag without defining it '
                             '(engine_upsampling.py:107); defined here so the '
                             'attribute always exists')
    return parser


# ---------------------------------------------------------------------------
# Static model configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageConfig:
    """Static per-stage geometry for one Swin stage."""
    dim: int                      # channel width at this stage
    depth: int                    # number of Swin blocks
    num_heads: int
    grid: Tuple[int, int]         # (H, W) token grid entering the stage blocks
    window: Tuple[int, int]       # effective window (after fallback resolution)
    shift: Tuple[int, int]        # shift for the odd (shifted) blocks
    drop_path: Tuple[float, ...]  # per-block stochastic depth rates


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """All static decisions for a TULIP model instance.

    Mirrors the constructor surface of the reference TULIP class
    (tulip/model/tulip.py:530-584) but resolves every runtime-mutating
    behaviour to config-time constants.
    """
    img_size: Tuple[int, int]
    target_img_size: Tuple[int, int]
    patch_size: Tuple[int, int]
    in_chans: int
    embed_dim: int
    window_size: Tuple[int, int]
    depths: Tuple[int, ...]
    num_heads: Tuple[int, ...]
    mlp_ratio: float
    qkv_bias: bool
    drop_rate: float
    attn_drop_rate: float
    drop_path_rate: float
    layer_norm_eps: float
    patch_norm: bool
    pixel_shuffle: bool
    circular_padding: bool
    swin_v2: bool
    log_transform: bool
    patch_unmerging: bool
    upscale_factor: int
    encoder_stages: Tuple[StageConfig, ...]
    decoder_stages: Tuple[StageConfig, ...]
    attn_impl: str = 'grouped'

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def patch_grid(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.patch_size[0],
                self.img_size[1] // self.patch_size[1])


def _resolve_window(grid: Tuple[int, int], window: Tuple[int, int],
                    shifted: bool) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Resolve the reference's runtime window fallback statically.

    Reference behaviour (tulip/model/tulip.py:213-222, 284-287): when the
    token-grid height is smaller than the window height, the module switches
    to a flat (1, wh*ww) window, with shift (0, wh*ww//2).
    """
    wh, ww = window
    if grid[0] < wh:
        flat = (1, wh * ww)
        return flat, ((0, flat[1] // 2) if shifted else (0, 0))
    return (wh, ww), ((wh // 2, ww // 2) if shifted else (0, 0))


def _drop_path_schedule(depths: Sequence[int], drop_path_rate: float):
    """Global linspace over sum(depths), sliced per stage
    (reference: tulip/model/tulip.py:409-410)."""
    total = sum(depths)
    if total <= 1:
        rates = [0.0] * total
    else:
        rates = [drop_path_rate * i / (total - 1) for i in range(total)]
    out, ofs = [], 0
    for d in depths:
        out.append(tuple(rates[ofs:ofs + d]))
        ofs += d
    return out


def model_config(
    model_select: str,
    img_size: Tuple[int, int],
    target_img_size: Tuple[int, int],
    patch_size: Tuple[int, int] = (1, 4),
    in_chans: int = 1,
    window_size: Tuple[int, int] = (2, 8),
    pixel_shuffle: bool = False,
    circular_padding: bool = False,
    swin_v2: bool = False,
    log_transform: bool = False,
    patch_unmerging: bool = False,
    drop_rate: float = 0.0,
    attn_drop_rate: float = 0.0,
    drop_path_rate: float = 0.1,
    attn_impl: str = 'grouped',
    depths: Optional[Tuple[int, ...]] = None,
    num_heads: Optional[Tuple[int, ...]] = None,
) -> ModelConfig:
    """Build the static model config for 'tulip_base' / 'tulip_large'.

    Variant hyperparameters follow the reference factories
    (tulip/model/tulip.py:739-755): base depths (2,2,2,2) heads (3,6,12,24);
    large depths (2,2,2,2,2) heads (3,6,12,24,48); both embed_dim 96,
    mlp_ratio 4, LayerNorm eps 1e-6.

    ``depths``/``num_heads`` override the variant defaults; they are a test
    hook (tiny configs run the identical stage machinery in seconds on
    the CPU) and are not part of the reference CLI surface.
    """
    if model_select == 'tulip_base':
        d_depths, d_heads = (2, 2, 2, 2), (3, 6, 12, 24)
    elif model_select == 'tulip_large':
        d_depths, d_heads = (2, 2, 2, 2, 2), (3, 6, 12, 24, 48)
    else:
        raise ValueError(f'unknown model_select: {model_select}')
    depths = tuple(depths) if depths is not None else d_depths
    num_heads = tuple(num_heads) if num_heads is not None else d_heads
    assert len(depths) == len(num_heads)

    img_size = tuple(img_size)
    target_img_size = tuple(target_img_size)
    patch_size = tuple(patch_size)
    window_size = tuple(window_size)
    embed_dim = 96
    num_layers = len(depths)

    # upscale factor of the head (reference: tulip/model/tulip.py:577)
    upscale_factor = (
        int(((target_img_size[0] * target_img_size[1])
             / (img_size[0] * img_size[1])) ** 0.5)
        * 2 * int(((patch_size[0] * patch_size[1]) // 4) ** 0.5))

    dpr = _drop_path_schedule(depths, drop_path_rate)

    grid = (img_size[0] // patch_size[0], img_size[1] // patch_size[1])
    enc = []
    g = grid
    for i in range(num_layers):
        win, shift = _resolve_window(g, window_size, shifted=True)
        enc.append(StageConfig(
            dim=embed_dim * 2 ** i, depth=depths[i], num_heads=num_heads[i],
            grid=g, window=win, shift=shift, drop_path=dpr[i]))
        if i < num_layers - 1:   # patch merging halves the grid
            g = ((g[0] + 1) // 2, (g[1] + 1) // 2)

    # Decoder stages operate at the encoder grids in reverse order, skipping
    # the deepest stage (reference: tulip/model/tulip.py:662-680).  Decoder
    # stage i uses reference index (num_layers - i - 2).
    dec = []
    for i in range(num_layers - 1):
        ref_idx = num_layers - i - 2
        g = enc[ref_idx].grid
        win, shift = _resolve_window(g, window_size, shifted=True)
        dec.append(StageConfig(
            dim=embed_dim * 2 ** ref_idx, depth=depths[ref_idx],
            num_heads=num_heads[ref_idx], grid=g, window=win, shift=shift,
            drop_path=dpr[ref_idx]))

    return ModelConfig(
        img_size=img_size, target_img_size=target_img_size,
        patch_size=patch_size, in_chans=in_chans, embed_dim=embed_dim,
        window_size=window_size, depths=depths, num_heads=num_heads,
        mlp_ratio=4.0, qkv_bias=True, drop_rate=drop_rate,
        attn_drop_rate=attn_drop_rate, drop_path_rate=drop_path_rate,
        layer_norm_eps=1e-6, patch_norm=True, pixel_shuffle=pixel_shuffle,
        circular_padding=circular_padding, swin_v2=swin_v2,
        log_transform=log_transform, patch_unmerging=patch_unmerging,
        upscale_factor=upscale_factor,
        encoder_stages=tuple(enc), decoder_stages=tuple(dec),
        attn_impl=attn_impl)


def model_config_from_args(args) -> ModelConfig:
    """Build a ModelConfig from parsed CLI args (the reference wires the same
    argparse fields into the TULIP constructor at main_lidar_upsampling.py:221-230).

    ``--attn_impl`` is carried into the config as given and selects nothing:
    the JAX package downgrades 'pallas' to 'grouped' on a CPU backend, the
    port's one implementation dispatches on the tensor's device."""
    return model_config(
        model_select=args.model_select,
        img_size=tuple(args.img_size_low_res),
        target_img_size=tuple(args.img_size_high_res),
        patch_size=tuple(args.patch_size),
        in_chans=args.in_chans,
        window_size=tuple(args.window_size),
        pixel_shuffle=args.pixel_shuffle,
        circular_padding=args.circular_padding,
        swin_v2=args.swin_v2,
        log_transform=args.log_transform,
        patch_unmerging=args.patch_unmerging,
        attn_impl=getattr(args, 'attn_impl', 'grouped'),
    )
