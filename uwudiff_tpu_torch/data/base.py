"""Datasets, collate, the loader and the data module (``uwudiff_tpu/data/base.py``).

As in the JAX package: NHWC samples; collate returns a dict of fixed-shape
numpy arrays (the trainer moves them to its device); the loader is a plain
deterministic iterator whose ``state_dict``/``load_state_dict`` make a
mid-epoch resume exact. ``shard_per_process`` (multi-host sharding from the
process group) and aspect-bucket datasets are not ported (ROADMAP.md,
Queue 1 items 17 and 13); an explicit ``shard_id``/``num_shards`` is.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from uwudiff_tpu_torch.config import instantiate_any

__all__ = ["UwUBaseDataset", "DummyDataset", "TrainDataModule", "DataLoader"]


class UwUBaseDataset:
    """Base dataset with the canonical collate."""

    tokenizers: Sequence = ()
    # train-time long prompts: captions tokenized into this many A1111-style
    # 77-token windows ([1, n * L] ids, models/long_prompt.py; the text
    # encoders fold the windows into the batch axis). None: one window. The
    # count is fixed per dataset, so every batch keeps one shape
    long_prompt_chunks: int | None = None

    def set_tokenizers(self, tokenizers):
        self.tokenizers = list(tokenizers)

    def _tokenize(self, caption: str) -> list[dict]:
        """Per-item tokenizer outputs; honours ``long_prompt_chunks``."""
        if self.long_prompt_chunks:
            from uwudiff_tpu_torch.models.long_prompt import _is_windowed, tokenize_long

            outs = []
            for tok in self.tokenizers:
                if _is_windowed(tok):
                    out, _w, _n = tokenize_long(tok, [caption], max_chunks=self.long_prompt_chunks)
                    outs.append(out)
                else:  # T5-style tokenizers keep one long window
                    outs.append(tok(caption, padding="max_length", truncation=True))
            return outs
        return [tok(caption, padding="max_length", truncation=True) for tok in self.tokenizers]

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, index: int) -> dict:  # pragma: no cover - abstract
        raise NotImplementedError

    @staticmethod
    def collate(batch: list[dict]) -> dict[str, Any]:
        samples = np.stack([x["sample"] for x in batch]).astype(np.float32)
        captions = [x["caption"] for x in batch]
        add_time_ids = np.stack([x["add_time_ids"] for x in batch]).astype(np.float32)
        tokenizer_outputs = []
        for tokenizer_out in zip(*[x["tokenizer_out"] for x in batch]):
            input_ids = np.concatenate([t["input_ids"] for t in tokenizer_out])
            attention_mask = np.concatenate([t["attention_mask"] for t in tokenizer_out])
            tokenizer_outputs.append({"input_ids": input_ids, "attention_mask": attention_mask})
        out = {
            "sample": samples,
            "captions": captions,
            "tokenizer_outputs": tokenizer_outputs,
            "added_cond": {"time_ids": add_time_ids},
            "cross_attention_kwargs": {},
        }
        if "class_label" in batch[0]:  # class-conditional (DiT family)
            out["class_labels"] = np.asarray([x["class_label"] for x in batch], np.int32)
        if "control_cond" in batch[0]:  # ControlNet hint images
            out["control_cond"] = np.stack([x["control_cond"] for x in batch]).astype(np.float32)
        if "ip_embed" in batch[0]:  # IP-Adapter image embeddings
            out["ip_embeds"] = np.stack([x["ip_embed"] for x in batch]).astype(np.float32)
        if "loss_mask" in batch[0]:  # masked loss ([H, W] in [0, 1])
            out["loss_mask"] = np.stack([x["loss_mask"] for x in batch]).astype(np.float32)
        return out


class DummyDataset(UwUBaseDataset):
    """Random-tensor dataset with a constant caption, the fake-data fixture
    of the pipeline. ``sample_size`` is NHWC-style ``(H, W, C)``: (256, 256,
    3) pixels or (32, 32, 4) latents. Every array is drawn at construction
    from numpy's ``default_rng(seed)`` in the JAX dataset's order, so both
    packages' datasets hold the same values."""

    def __init__(
        self,
        sample_size: tuple[int, ...] = (256, 256, 3),
        n_samples: int = 100,
        tokenizers: Sequence = (),
        caption: str = "DUMMY TEST",
        seed: int = 0,
        n_classes: int | None = None,
        control_size: tuple[int, ...] | None = None,  # ControlNet: (H, W, C) of the pixel-space hint
        ip_embed_dim: int | None = None,  # IP-Adapter: width of the per-item image embedding
        with_loss_mask: bool = False,  # a random binary [H, W] loss_mask per item
        long_prompt_chunks: int | None = None,
        **kwargs,
    ):
        self.long_prompt_chunks = long_prompt_chunks
        self.sample_size = tuple(sample_size)
        rng = np.random.default_rng(seed)
        self.samples = [rng.standard_normal(self.sample_size).astype(np.float32) for _ in range(n_samples)]
        self.tokenizers = list(tokenizers) if isinstance(tokenizers, (list, tuple)) else [tokenizers]
        self.caption = caption
        self.n_classes = n_classes
        self.labels = rng.integers(0, n_classes, size=n_samples).astype(np.int32) if n_classes else None
        self.control_size = tuple(control_size) if control_size else None
        self.controls = ([rng.standard_normal(self.control_size).astype(np.float32) for _ in range(n_samples)]
                         if self.control_size else None)
        self.ip_embeds = ([rng.standard_normal((ip_embed_dim,)).astype(np.float32) for _ in range(n_samples)]
                          if ip_embed_dim else None)
        self.loss_masks = ([(rng.random(self.sample_size[:2]) > 0.5).astype(np.float32) for _ in range(n_samples)]
                           if with_loss_mask else None)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> dict:
        h, w = self.sample_size[0], self.sample_size[1]
        item = {
            "sample": self.samples[index],
            "caption": self.caption,
            "tokenizer_out": self._tokenize(self.caption),
            # org_h, org_w, crop_top, crop_left, target_h, target_w
            "add_time_ids": np.asarray([h, w, 0, 0, h, w], dtype=np.float32),
        }
        if self.labels is not None:
            item["class_label"] = int(self.labels[index])
        if self.controls is not None:
            item["control_cond"] = self.controls[index]
        if self.ip_embeds is not None:
            item["ip_embed"] = self.ip_embeds[index]
        if self.loss_masks is not None:
            item["loss_mask"] = self.loss_masks[index]
        return item


class DataLoader:
    """Deterministic shuffling batcher with an exact resume state.

    The order of epoch ``e`` is ``default_rng(seed + e)``'s shuffle of the
    indices. ``shard_id``/``num_shards`` keep one contiguous, balanced part
    of that order (every shard truncated to the shortest, so all see the
    same batch count); ``batch_size`` is per shard."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        collate_fn=None,
        shard_id: int | None = None,
        num_shards: int | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        # an attribute lookup, so a dataset may override collate per instance
        self.collate_fn = collate_fn or dataset.collate
        if (shard_id is None) != (num_shards is None):
            raise ValueError("shard_id and num_shards must be set together")
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.epoch = 0
        self.batch_idx = 0  # next batch to yield within the epoch

    def _shard_len(self) -> int:
        n = len(self.dataset)
        return n if self.num_shards is None else n // self.num_shards

    def __len__(self):
        n = self._shard_len() // self.batch_size
        if not self.drop_last and self._shard_len() % self.batch_size:
            n += 1
        return n

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        if self.num_shards is not None:
            # the JAX package's balance_sharding: each shard in turn takes the
            # remaining indices // the shards left; then truncated
            total, start = len(idx), 0
            for k in range(self.shard_id):
                start += total // (self.num_shards - k)
                total -= total // (self.num_shards - k)
            size = total // (self.num_shards - self.shard_id)
            idx = idx[start:start + size][: self._shard_len()]
        return idx

    def _epoch(self):
        order = self._order()
        n_batches = len(self)
        while self.batch_idx < n_batches:
            lo = self.batch_idx * self.batch_size
            hi = min(lo + self.batch_size, len(order))
            batch = [self.dataset[int(i)] for i in order[lo:hi]]
            self.batch_idx += 1
            yield self.collate_fn(batch)
        self.epoch += 1
        self.batch_idx = 0

    def __iter__(self):
        while True:
            yield from self._epoch()

    def epoch_iter(self):
        """Iterate the remainder of the current epoch, then stop."""
        yield from self._epoch()

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "batch_idx": self.batch_idx}

    def load_state_dict(self, state: dict):
        self.epoch = int(state["epoch"])
        self.batch_idx = int(state["batch_idx"])


class TrainDataModule:
    """Config-driven dataset + loader pairing."""

    def __init__(self, dataset_config, dataloader_config=None, val_dataset_config=None):
        self.dataset_config = dataset_config
        self.dataloader_config = dict(dataloader_config or {})
        self.val_dataset_config = val_dataset_config
        self.tokenizers = None
        self.dataset = None
        self.val_dataset = None

    def set_tokenizers(self, tokenizers):
        self.tokenizers = list(tokenizers)
        if self.dataset is not None:
            self.dataset.set_tokenizers(self.tokenizers)
        if self.val_dataset is not None:
            self.val_dataset.set_tokenizers(self.tokenizers)

    def setup(self):
        if self.dataset is None:
            self.dataset = instantiate_any(self.dataset_config)
            if self.tokenizers:
                self.dataset.set_tokenizers(self.tokenizers)
        if self.val_dataset is None and self.val_dataset_config is not None:
            self.val_dataset = instantiate_any(self.val_dataset_config)
            if self.tokenizers:
                self.val_dataset.set_tokenizers(self.tokenizers)
        return self

    def _loader_config(self) -> dict:
        cfg = dict(self.dataloader_config)
        cfg.pop("num_workers", None)  # accepted for config parity; unused
        if cfg.pop("shard_per_process", False):
            raise NotImplementedError("shard_per_process (a shard per process of a multi-host run) is not ported"
                                      " yet (ROADMAP.md, Queue 1 item 17)")
        return cfg

    def train_dataloader(self) -> DataLoader:
        self.setup()
        return DataLoader(self.dataset, collate_fn=self.dataset.collate, **self._loader_config())

    def val_dataloader(self) -> DataLoader | None:
        self.setup()
        if self.val_dataset is None:
            return None
        cfg = self._loader_config()
        cfg["shuffle"] = False
        return DataLoader(self.val_dataset, collate_fn=self.val_dataset.collate, **cfg)
