"""Dataset registry + builders for durlar/kitti/carla.

Parity targets: tulip/util/datasets.py:41-52 (registry), 196-242
(RangeMapFolder), 153-161 (PairDataset), 244-369 (builders).  The builders
reproduce the exact transform chains and directory layouts so the shipped
bash_scripts workflows see identical data.  The port's copy of
tulip_tpu/data/datasets.py: the DurLAR and KITTI builders hand their folders
the fused native reader's spec (data/native.py), with JAX's numbers; CARLA
(.rimg) stays on the numpy loader and transform chain.  Unlike JAX, a
folder decides once, at construction, from its first file's header, whether
it reads natively; a read that then fails raises instead of falling back.
"""

from __future__ import annotations

import bisect
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import native
from .loaders import npy_loader, rimg_loader
from .transforms import (
    Compose, DownsampleTensor, DownsampleTensorWidth, FilterInvalidPixels,
    LogTransform, RandomRollRangeMap, ScaleTensor, ToChannelFirst,
)

NPY_EXTENSIONS = ('.npy', '.rimg', '.bin')

dataset_list: Dict[str, Callable] = {}


def register_dataset(name):
    """Decorator registry keyed by dataset name
    (reference: tulip/util/datasets.py:43-47)."""
    def decorator(fn):
        dataset_list[name] = fn
        return fn
    return decorator


def generate_dataset(args, is_train):
    """(reference: tulip/util/datasets.py:50-52)"""
    dataset = dataset_list[args.dataset_select]
    return dataset(is_train, args)


class RangeMapFolder:
    """Flat-folder dataset of range maps; with ``class_dir=False`` files live
    directly under ``root`` (reference: tulip/util/datasets.py:196-242).
    Items are dicts {'sample', 'class', 'name'}.

    ``native_spec``: the fused native reader's keyword arguments
    (data/native.read_range_map), which compute what loader + transform
    compute.  With a spec, the folder reads natively when its first file is
    a .npy of the kind loader.cpp reads (data/native.native_shape), and
    then every file goes through the reader; ``post_transform`` (the roll
    augment) applies after it, to an item or to a whole batch.  Otherwise,
    or without a spec, every file takes ``loader`` and ``transform``.
    ``native_shape`` is the (rows, cols) of a natively read item, or None
    where the folder takes the numpy chain."""

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 loader: Callable[[str], Any] = npy_loader,
                 class_dir: bool = True,
                 native_spec: Optional[dict] = None,
                 post_transform: Optional[Callable] = None):
        self.root = root
        self.transform = transform
        self.loader = loader
        self.class_dir = class_dir
        self.native_spec = dict(native_spec) if native_spec else None
        self.post_transform = post_transform
        self.classes, self.class_to_idx = self._find_classes(root)
        self.samples = self._make_dataset(root)
        self.imgs = self.samples
        if not self.samples:
            raise FileNotFoundError(
                f"Found no files with extensions {NPY_EXTENSIONS} under {root}")
        self.native_shape = self._native_out_shape()

    @property
    def native(self) -> bool:
        return self.native_shape is not None

    def _find_classes(self, directory: str):
        if self.class_dir:
            classes = sorted(e.name for e in os.scandir(directory) if e.is_dir())
            if not classes:
                raise FileNotFoundError(f"Couldn't find any class folder in {directory}.")
            return classes, {c: i for i, c in enumerate(classes)}
        return [""], {"": 0}

    def _make_dataset(self, directory: str) -> List:
        instances = []
        for target_class in sorted(self.class_to_idx.keys()):
            class_index = self.class_to_idx[target_class]
            target_dir = os.path.join(directory, target_class) if target_class else directory
            if not os.path.isdir(target_dir):
                continue
            for dirpath, _, fnames in sorted(os.walk(target_dir, followlinks=True)):
                for fname in sorted(fnames):
                    if fname.lower().endswith(NPY_EXTENSIONS):
                        instances.append((os.path.join(dirpath, fname), class_index))
        return instances

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        path, target = self.samples[index]
        name = os.path.basename(path)
        if self.native:
            sample = native.read_range_map(path, **self.native_spec)[None]
            if self.post_transform is not None:
                sample = self.post_transform(sample)
        else:
            sample = self.loader(path)
            if self.transform is not None:
                sample = self.transform(sample)
            native.count("numpy_items")
        return {'sample': sample, 'class': target, 'name': name}

    def _native_out_shape(self):
        if self.native_spec is None:
            return None
        shape = native.native_shape(self.samples[0][0])
        if shape is None:
            return None
        sp = self.native_spec
        return native.output_shape(shape[0], shape[1],
                                   sp.get("row_start", 0),
                                   sp.get("row_stride", 0),
                                   sp.get("col_stride", 0))

    def read_batch(self, indices, num_threads: int = 8):
        """The collated items at ``indices`` in one native call over a
        pthread pool (the interpreter lock released); a folder that takes
        the numpy chain raises."""
        if not self.native:
            raise ValueError(f"{self.root} takes the numpy chain, not the "
                             f"native reader")
        paths = [self.samples[i][0] for i in indices]
        out = native.read_range_batch(paths, out_shape=self.native_shape,
                                      num_threads=num_threads,
                                      **self.native_spec)
        if self.post_transform is not None:
            out = self.post_transform(out)
        return {"sample": out,
                "class": np.asarray([self.samples[i][1] for i in indices]),
                "name": [os.path.basename(p) for p in paths]}


class PairDataset:
    """Zip of datasets; len = min (reference: tulip/util/datasets.py:153-161)."""

    def __init__(self, *datasets):
        self.datasets = datasets

    def __getitem__(self, i):
        return tuple(d[i] for d in self.datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    @property
    def native(self) -> bool:
        """Every member is a folder that reads natively."""
        return all(getattr(d, "native", False) for d in self.datasets)

    def read_batch(self, indices, num_threads: int = 8):
        return tuple(d.read_batch(indices, num_threads=num_threads)
                     for d in self.datasets)


class ConcatDataset:
    """Concatenation of datasets (stand-in for torch.utils.data.ConcatDataset,
    used by the CARLA builder at tulip/util/datasets.py:364-365)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1] if self.cumulative_sizes else 0

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        inner = idx if ds_idx == 0 else idx - self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][inner]


@register_dataset('durlar')
def build_durlar_upsampling_dataset(is_train, args):
    """(reference: tulip/util/datasets.py:244-278)"""
    input_size = tuple(args.img_size_low_res)
    output_size = tuple(args.img_size_high_res)

    t_low_res = [ToChannelFirst(), ScaleTensor(1 / 120),
                 FilterInvalidPixels(min_range=0.3 / 120, max_range=1)]
    t_high_res = [ToChannelFirst(), ScaleTensor(1 / 120),
                  FilterInvalidPixels(min_range=0.3 / 120, max_range=1)]

    t_low_res.append(DownsampleTensor(
        h_high_res=output_size[0],
        downsample_factor=output_size[0] // input_size[0]))

    if args.log_transform:
        t_low_res.append(LogTransform())
        t_high_res.append(LogTransform())

    post_low = post_high = None
    if is_train and args.roll:
        roll_low_res = RandomRollRangeMap()
        roll_high_res = RandomRollRangeMap(shift=roll_low_res.shift)
        t_low_res.append(roll_low_res)
        t_high_res.append(roll_high_res)
        post_low, post_high = roll_low_res, roll_high_res

    root_low_res = os.path.join(args.data_path_low_res, 'train' if is_train else 'val')
    root_high_res = os.path.join(args.data_path_high_res, 'train' if is_train else 'val')

    # the fused native reader's specs: the same chains in one pass
    spec = dict(scale=1 / 120, min_r=0.3 / 120, max_r=1.0,
                log1p=bool(args.log_transform))
    native_low = dict(spec, row_stride=output_size[0] // input_size[0])
    native_high = dict(spec)

    dataset_low_res = RangeMapFolder(root_low_res, transform=Compose(t_low_res),
                                     loader=npy_loader, class_dir=False,
                                     native_spec=native_low,
                                     post_transform=post_low)
    dataset_high_res = RangeMapFolder(root_high_res, transform=Compose(t_high_res),
                                      loader=npy_loader, class_dir=False,
                                      native_spec=native_high,
                                      post_transform=post_high)
    assert len(dataset_high_res) == len(dataset_low_res)
    return PairDataset(dataset_low_res, dataset_high_res)


@register_dataset('kitti')
def build_kitti_upsampling_dataset(is_train, args):
    """(reference: tulip/util/datasets.py:280-309).  NOTE (parity): KITTI has
    no FilterInvalidPixels in its transform chain."""
    input_size = tuple(args.img_size_low_res)
    output_size = tuple(args.img_size_high_res)

    t_low_res = [ToChannelFirst(), ScaleTensor(1 / 80)]
    t_high_res = [ToChannelFirst(), ScaleTensor(1 / 80)]

    t_low_res.append(DownsampleTensor(
        h_high_res=output_size[0],
        downsample_factor=output_size[0] // input_size[0]))
    if output_size[1] // input_size[1] > 1:
        t_low_res.append(DownsampleTensorWidth(
            w_high_res=output_size[1],
            downsample_factor=output_size[1] // input_size[1]))

    if args.log_transform:
        t_low_res.append(LogTransform())
        t_high_res.append(LogTransform())

    root_low_res = os.path.join(args.data_path_low_res, 'train' if is_train else 'val')
    root_high_res = os.path.join(args.data_path_high_res, 'train' if is_train else 'val')

    # the fused native reader's specs (no range gate on KITTI)
    spec = dict(scale=1 / 80, log1p=bool(args.log_transform))
    native_low = dict(spec, row_stride=output_size[0] // input_size[0])
    if output_size[1] // input_size[1] > 1:
        native_low["col_stride"] = output_size[1] // input_size[1]
    native_high = dict(spec)

    dataset_low_res = RangeMapFolder(root_low_res, transform=Compose(t_low_res),
                                     loader=npy_loader, class_dir=False,
                                     native_spec=native_low)
    dataset_high_res = RangeMapFolder(root_high_res, transform=Compose(t_high_res),
                                      loader=npy_loader, class_dir=False,
                                      native_spec=native_high)
    assert len(dataset_high_res) == len(dataset_low_res)
    return PairDataset(dataset_low_res, dataset_high_res)


@register_dataset('carla')
def build_carla_upsampling_dataset(is_train, args):
    """(reference: tulip/util/datasets.py:312-369).  Per-town directories with
    per-resolution subdirs; Town01..06 train, Town07/Town10HD val."""
    input_size = tuple(args.img_size_low_res)
    output_size = tuple(args.img_size_high_res)
    input_img_path = f'{input_size[0]}_{input_size[1]}'
    output_img_path = f'{output_size[0]}_{output_size[1]}'

    available_resolution = os.listdir(os.path.join(args.data_path_low_res, 'Town01'))

    t_low_res = [ToChannelFirst(), ScaleTensor(1 / 80),
                 FilterInvalidPixels(min_range=2 / 80, max_range=1)]
    t_high_res = [ToChannelFirst(), ScaleTensor(1 / 80),
                  FilterInvalidPixels(min_range=2 / 80, max_range=1)]

    input_data_unavailable = (input_img_path not in available_resolution
                              and output_img_path in available_resolution)
    if input_data_unavailable:
        print("There is no data for the specified input size but output size "
              "is available, Downsample input data from the output")
        t_low_res.append(DownsampleTensor(
            h_high_res=output_size[0],
            downsample_factor=output_size[0] // input_size[0]))

    if args.log_transform:
        t_low_res.append(LogTransform())
        t_high_res.append(LogTransform())

    transform_low_res = Compose(t_low_res)
    transform_high_res = Compose(t_high_res)

    scene_ids = ['Town01', 'Town02', 'Town03', 'Town04', 'Town05', 'Town06'] \
        if is_train else ['Town07', 'Town10HD']

    scenes_data_input, scenes_data_output = [], []
    for scene in scene_ids:
        in_res = output_img_path if input_data_unavailable else input_img_path
        input_scene_datapath = os.path.join(args.data_path_low_res, scene, in_res)
        output_scene_datapath = os.path.join(args.data_path_high_res, scene, output_img_path)
        scenes_data_input.append(RangeMapFolder(
            input_scene_datapath, transform=transform_low_res,
            loader=rimg_loader, class_dir=False))
        scenes_data_output.append(RangeMapFolder(
            output_scene_datapath, transform=transform_high_res,
            loader=rimg_loader, class_dir=False))

    return PairDataset(ConcatDataset(scenes_data_input),
                       ConcatDataset(scenes_data_output))
