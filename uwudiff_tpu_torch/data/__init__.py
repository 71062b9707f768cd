"""The data layer of the port: datasets, the deterministic loader and the
data module (``uwudiff_tpu/data``). ``base`` is ported; the local, HF,
webdataset, aspect-bucket and DreamBooth datasets are not (ROADMAP.md,
Queue 1 item 13)."""

from uwudiff_tpu_torch.data.base import DataLoader, DummyDataset, TrainDataModule, UwUBaseDataset

__all__ = ["DataLoader", "DummyDataset", "TrainDataModule", "UwUBaseDataset"]
