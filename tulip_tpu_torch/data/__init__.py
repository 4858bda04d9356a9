from .loaders import npy_loader, rimg_loader, bin_loader
from .transforms import (
    ToChannelFirst, ScaleTensor, FilterInvalidPixels, LogTransform,
    DownsampleTensor, DownsampleTensorWidth, RandomRollRangeMap,
    AddGaussianNoise, CropRanges, KeepCloseScan, KeepFarScan,
    DepthwiseConcatenation, Compose,
)
from .datasets import (
    register_dataset, generate_dataset, dataset_list,
    RangeMapFolder, PairDataset, ConcatDataset,
)
from .pipeline import DataLoader, ShardedSampler
