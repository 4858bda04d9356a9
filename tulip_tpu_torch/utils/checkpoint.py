"""Checkpoints (port of tulip_tpu/utils/checkpoint.py) and the weight
exchange with the JAX package.

The port's own checkpoint is the reference's ``.pth`` (tulip/util/misc.py:
332-349): ``torch.save`` of {'model', 'optimizer', 'epoch', 'scaler',
'args'} with the reference's state-dict key names and torch layouts, named
``checkpoint-{epoch}.pth``.  With gradient accumulation the buffer and the
micro-step counter ride along under 'accum', so a resume in mid-accumulation
is exact.  The JAX package reads such a file through the torch branch of
its ``load_checkpoint``.

:func:`load_checkpoint` also reads the JAX package's native file (a magic
line and a pickle of numpy trees): JAX params are a flat dict under the same
reference key names, in JAX layouts, Linear (in, out) and Conv2d HWIO, the
relative-position bias table as it is.  Its optimizer tree holds optax
namedtuples; they are unpickled into plain tuple stand-ins (this package
imports neither optax nor jax) and AdamW's count and moments, and
``MultiSteps``' accumulation, are read out of them.
"""

from __future__ import annotations

import glob
import os
import pickle
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

_NATIVE_MAGIC = b"TULIPTPU1\n"

_NON_LINEAR_2D = ("relative_position_bias_table",)
_DROP_SUFFIXES = ("relative_position_index", "attn_mask",
                  "relative_coords_table")

# legacy key remaps (reference: tulip/util/misc.py:370-379)
_LEGACY_REMAP = {
    "head.weight": "decoder_pred.weight",
    "pixel_shuffle_layer.conv_expand.0.weight": "ps_head.conv_expand.0.weight",
    "pixel_shuffle_layer.conv_expand.0.bias": "ps_head.conv_expand.0.bias",
}


def state_dict_from_jax(params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX param dict (numpy arrays) -> torch state dict (CPU tensors)."""
    out = {}
    for k, v in params.items():
        arr = np.array(v, dtype=np.float32)   # a writable copy
        if k.endswith(".weight"):
            if arr.ndim == 4:                    # HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2 and not any(t in k for t in _NON_LINEAR_2D):
                arr = arr.T                      # (in, out) -> (out, in)
        out[k] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def jax_params_from_state_dict(
        state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Torch state dict (or a dict of its gradients) -> JAX param dict of
    fp32 numpy arrays (copies: later in-place updates of the tensors do not
    show through): the inverse of :func:`state_dict_from_jax`."""
    out = {}
    for k, v in state.items():
        arr = v.detach().cpu().float().numpy()
        if k.endswith(".weight"):
            if arr.ndim == 4:                    # OIHW -> HWIO
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2 and not any(t in k for t in _NON_LINEAR_2D):
                arr = arr.T                      # (out, in) -> (in, out)
        out[k] = np.array(arr, order="C")
    return out


def load_jax_params(model: nn.Module, params: Dict[str, np.ndarray]) -> None:
    """Load JAX params into ``model`` (strict: every key must match)."""
    model.load_state_dict(state_dict_from_jax(params), strict=True)


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------

def _plain_args(args) -> dict:
    if args is None:
        return {}
    return {k: v for k, v in vars(args).items()
            if isinstance(v, (int, float, str, bool, list, tuple, type(None)))}


def save_checkpoint(path: str, model: nn.Module, optimizer=None,
                    epoch: int = 0, args: Optional[dict] = None,
                    train_step=None) -> None:
    """Write a checkpoint in the reference's dict layout (misc.py:338-346);
    'scaler' is a stub: bf16 needs no loss scaling.  Written to a temporary
    file and moved into place, so a reader never sees half a file."""
    cpu = lambda t: t.detach().cpu()
    payload = {
        "model": {k: cpu(v) for k, v in model.state_dict().items()},
        "optimizer": None if optimizer is None else optimizer.state_dict(),
        "epoch": epoch,
        "scaler": {},
        "args": args or {},
    }
    accum = None if train_step is None else train_step.state_dict()
    if accum is not None:
        payload["accum"] = accum
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_model(args, epoch: int, model: nn.Module, optimizer,
               train_step=None) -> None:
    """(reference: misc.py:332-349); the caller gates on rank 0 and then
    waits at a barrier, so no rank reads a checkpoint before it is whole."""
    path = Path(args.output_dir) / f"checkpoint-{epoch}.pth"
    save_checkpoint(str(path), model, optimizer, epoch,
                    args=_plain_args(args), train_step=train_step)


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------

class _Record(tuple):
    """Stand-in for a namedtuple class of optax / jax met while unpickling:
    a plain tuple of the fields, in order, that remembers the class name."""

    def __new__(cls, *fields):
        return super().__new__(cls, fields)


class _NativeUnpickler(pickle.Unpickler):
    """Reads the JAX package's native payload where optax and jax are not
    installed: their classes (namedtuples, all leaves already numpy) become
    :class:`_Record` subclasses; everything else unpickles as usual."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("optax", "jax", "jaxlib", "chex", "flax"):
            return type(name, (_Record,), {"__module__": module})
        return super().find_class(module, name)


def _load_native(path: str):
    with open(path, "rb") as f:
        if f.read(len(_NATIVE_MAGIC)) != _NATIVE_MAGIC:
            return None
        return _NativeUnpickler(f).load()


def _find_record(tree, name: str):
    """First :class:`_Record` called ``name`` in a tree of tuples / dicts."""
    if isinstance(tree, _Record) and type(tree).__name__ == name:
        return tree
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, (tuple, list)):
        for item in tree:
            found = _find_record(item, name)
            if found is not None:
                return found
    return None


def _optimizer_from_optax(tree, path: str):
    """(adam, accum) out of the JAX package's optimizer tree: AdamW's step
    count and moments in torch layouts, and optax.MultiSteps' micro-step and
    gradient buffer when the tree has them.  MultiSteps keeps the running
    mean of the micro-steps' gradients; the port's buffer holds their sum
    over accum_iter, so the caller scales by micro / accum_iter."""
    adam = _find_record(tree, "ScaleByAdamState")
    if (adam is None or len(adam) != 3
            or not all(isinstance(m, dict) for m in adam[1:])):
        raise ValueError(
            f"{path}: the optimizer tree is not the AdamW state this port "
            f"reads (no ScaleByAdamState(count, mu, nu) of parameter dicts "
            f"in {type(tree).__name__}); refusing to drop the moments")
    count, mu, nu = adam
    out = {"step": int(np.asarray(count)),
           "exp_avg": state_dict_from_jax(mu),
           "exp_avg_sq": state_dict_from_jax(nu)}
    multi = _find_record(tree, "MultiStepsState")
    accum = None
    if multi is not None:
        if len(multi) < 4 or not isinstance(multi[3], dict):
            raise ValueError(
                f"{path}: MultiStepsState without (mini_step, gradient_step, "
                f"inner_opt_state, acc_grads) as this port reads it")
        accum = {"micro": int(np.asarray(multi[0])),
                 "mean_grads": state_dict_from_jax(multi[3])}
    return out, accum


def _remap_legacy(state_dict) -> Dict[str, torch.Tensor]:
    """The reference's legacy key remaps, and its buffers dropped (the model
    computes them at construction)."""
    out = {}
    for k, v in state_dict.items():
        k = _LEGACY_REMAP.get(k, k)
        if any(k.endswith(s) for s in _DROP_SUFFIXES):
            continue
        out[k] = v
    return out


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint: the JAX package's native format or a torch .pth
    (the port's own, or a reference checkpoint).  Returns {'format', 'model':
    state dict in torch layouts, 'optimizer', 'accum', 'epoch', 'args'}.
    'optimizer' is a ``torch.optim.AdamW.state_dict()`` for format 'torch'
    and {'step', 'exp_avg', 'exp_avg_sq'} by parameter name for format
    'tulip_tpu'."""
    native = _load_native(path)
    if native is not None:
        opt = accum = None
        if native.get("optimizer") is not None:
            opt, accum = _optimizer_from_optax(native["optimizer"], path)
        return {"format": "tulip_tpu",
                "model": state_dict_from_jax(native["model"]),
                "optimizer": opt, "accum": accum,
                "epoch": native.get("epoch", 0),
                "args": native.get("args") or {}}
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        import argparse  # noqa: F401  (checkpoints embed an argparse.Namespace)
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    is_dict = isinstance(ckpt, dict) and "model" in ckpt
    state_dict = ckpt["model"] if is_dict else ckpt
    args = ckpt.get("args") if is_dict else None
    return {"format": "torch",
            "model": _remap_legacy(state_dict),
            "optimizer": ckpt.get("optimizer") if is_dict else None,
            "accum": ckpt.get("accum") if is_dict else None,
            "epoch": ckpt.get("epoch") if is_dict else None,
            "args": args if isinstance(args, dict) else {}}


def get_latest_checkpoint(args) -> None:
    """Glob checkpoint-*.pth, pick max epoch, set args.resume
    (reference: engine_upsampling.py:611-622)."""
    output_dir = Path(args.output_dir)
    all_checkpoints = glob.glob(os.path.join(output_dir, "checkpoint-*.pth"))
    latest_ckpt = -1
    for ckpt in all_checkpoints:
        t = ckpt.split("-")[-1].split(".")[0]
        if t.isdigit():
            latest_ckpt = max(int(t), latest_ckpt)
    if latest_ckpt >= 0:
        args.resume = os.path.join(output_dir, "checkpoint-%d.pth" % latest_ckpt)
    print("Find checkpoint: %s" % args.resume)


def _restore_adam(optimizer, model: nn.Module, adam: dict) -> None:
    """Write AdamW's step count and moments, given by parameter name, into
    ``optimizer``'s state (on each parameter's device)."""
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        m, v = adam["exp_avg"][name], adam["exp_avg_sq"][name]
        if tuple(m.shape) != tuple(p.shape):
            raise ValueError(f"optimizer moment shape mismatch for {name}: "
                             f"{tuple(m.shape)} vs {tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(adam["step"])),
            "exp_avg": m.to(device=p.device, dtype=p.dtype).clone(),
            "exp_avg_sq": v.to(device=p.device, dtype=p.dtype).clone()}


def load_model(args, model: nn.Module, optimizer=None, train_step=None) -> int:
    """Resume semantics of misc.load_model:361-470: restore the model
    always; restore the optimizer (and the accumulation state of
    ``train_step``) and move start_epoch past the checkpoint's epoch unless
    --eval.  Returns start_epoch.  Under data parallel every rank reads the
    same file; the caller then broadcasts the parameters from rank 0
    (parallel/mesh.py:replicate)."""
    start_epoch = getattr(args, "start_epoch", 0)
    if not args.resume:
        return start_epoch
    ckpt = load_checkpoint(args.resume)
    loaded = ckpt["model"]
    own = model.state_dict()
    missing = set(own) - set(loaded)
    unexpected = set(loaded) - set(own)
    if missing or unexpected:
        raise KeyError(f"checkpoint key mismatch: missing={sorted(missing)[:5]} "
                       f"unexpected={sorted(unexpected)[:5]}")
    for k, v in own.items():
        if tuple(loaded[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch for {k}: "
                             f"{tuple(loaded[k].shape)} vs {tuple(v.shape)}")
    model.load_state_dict(loaded, strict=True)
    print("Resume checkpoint %s" % args.resume)
    is_eval = getattr(args, "eval", False)
    if ckpt["optimizer"] is not None and not is_eval and optimizer is not None:
        if ckpt["format"] == "tulip_tpu":
            _restore_adam(optimizer, model, ckpt["optimizer"])
        else:
            optimizer.load_state_dict(ckpt["optimizer"])
        if train_step is not None:
            train_step.load_state_dict(ckpt["accum"])
        start_epoch = (ckpt["epoch"] or 0) + 1
        print("With optim & sched!")
    elif (ckpt["epoch"] is not None and not is_eval
          and ckpt["format"] == "tulip_tpu"):
        start_epoch = ckpt["epoch"] + 1
    return start_epoch


def initialize_decoder_weights(pretrain_model: Dict[str, Any]) -> Dict[str, Any]:
    """Verbatim-behavior port of the reference's dead helper
    (tulip/util/misc.py:218-249): transplants decoder-stage weights into the
    mirrored encoder-stage keys (layers_up.{2,1,0} -> layers.{0,1,2}, with
    downsample->upsample key rewriting), then strips head / decoder_pred /
    skip_connection / first_patch_expanding / output_weights and every
    remaining key containing 'up'.  Mutates and returns ``pretrain_model``.
    Never called at runtime in the reference either: kept for API parity."""
    for k in list(pretrain_model.keys()):
        for src, dst in (("layers.0", "layers_up.2"),
                         ("layers.1", "layers_up.1"),
                         ("layers.2", "layers_up.0")):
            if src in k:
                new_key = k.replace(src, dst)
                if "downsample" in new_key:
                    new_key = new_key.replace("downsample", "upsample")
                pretrain_model[k] = pretrain_model[new_key]
                del pretrain_model[new_key]

    for k in list(pretrain_model.keys()):
        if ("head" in k or "decoder_pred" in k or "skip_connection" in k
                or "first_patch_expanding" in k or "output_weights" in k
                or "up" in k):
            print(f"Removing key {k} from pretrained checkpoint")
            del pretrain_model[k]

    print(pretrain_model.keys())
    return pretrain_model
