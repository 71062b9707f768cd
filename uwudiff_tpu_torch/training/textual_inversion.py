"""Textual inversion (``uwudiff_tpu/training/textual_inversion.py``): train
only new token-embedding rows for a placeholder word against a frozen
model (Gal et al. 2022).

The trainable state is ``num_vectors`` rows per text model, named
``text_models_{i}``. Each text model's token table is enlarged by
``num_vectors`` rows, and the placeholder (``"<concept>"``) is registered
on every tokenizer to expand to the new ids. In the loss, the rows are
grafted onto the tail of each frozen table (``_graft_te_params``) and the
text encoders run with the grafted tables through
``torch.func.functional_call``, the counterpart of the JAX trainer's
``te.apply`` with grafted params: the loss backpropagates through the
frozen text transformers into the rows. CLIP towers that pool at
``argmax(input_ids)`` would pool at a placeholder id, so their
``eos_token_id`` is pinned from the tokenizer.

Every frozen module gets ``requires_grad_(False)``: the backward pass
computes input gradients only and stores no weight gradient for them.
Pretrained-checkpoint loading waits for the checkpoints (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from uwudiff_tpu_torch.models.clip import CLIPTextModel
from uwudiff_tpu_torch.training.trainer import DMTrainer

__all__ = ["TextualInversionTrainer"]


class TextualInversionTrainer(DMTrainer):
    """Trains placeholder-token embeddings against a frozen model. Takes
    ``DMTrainer``'s arguments plus ``placeholder_token``, ``num_vectors``
    and ``initializer_token`` (the rows start as that token's embedding;
    None draws N(0, 0.02))."""

    def __init__(self, model_config: dict, placeholder_token: str = "<concept>", num_vectors: int = 1,
                 initializer_token: str | None = None, **kwargs):
        super().__init__(model_config, **kwargs)
        if self.te is None:
            raise ValueError("textual inversion trains text-token embeddings: model_config must provide a te")
        self.placeholder_token, self.num_vectors = placeholder_token, num_vectors
        self.initializer_token = initializer_token
        self._base_vocabs = []
        for i, tok in enumerate(self.tokenizers):
            tm = getattr(self.te, self._emb_key(i))
            emb = tm.token_embedding
            self._base_vocabs.append(emb.num_embeddings)
            tail = emb.weight.new_zeros((num_vectors, emb.embedding_dim))  # replaced by the rows in the loss
            emb.weight = nn.Parameter(torch.cat([emb.weight.detach(), tail]), requires_grad=False)
            emb.num_embeddings += num_vectors
            if isinstance(tm, CLIPTextModel) and tm.eos_token_id is None:
                tm.eos_token_id = tok.eos_token_id
        for vocab, tok in zip(self._base_vocabs, self.tokenizers):
            tok.add_placeholder(placeholder_token, list(range(vocab, vocab + num_vectors)))

    # -- param plumbing -------------------------------------------------

    def _emb_key(self, i: int) -> str:
        return f"text_models_{i}"

    def _te_embedding_leaf(self, i: int) -> torch.Tensor:
        return getattr(self.te, self._emb_key(i)).token_embedding.weight

    def _graft_te_params(self, rows: dict) -> dict:
        """``{state-dict name: table}``: each frozen token table with the
        rows ``rows[text_models_{i}]`` written into its tail."""
        out = {}
        for i, vocab in enumerate(self._base_vocabs):
            table = self._te_embedding_leaf(i)
            key = self._emb_key(i)
            out[f"{key}.token_embedding.weight"] = torch.cat([table[:vocab], rows[key].to(table.dtype)])
        return out

    def _select_trainable_params(self):
        """Freeze the UNet and the text encoders on the device (their dtype
        kept) and make the rows: ``initializer_token``'s embedding repeated,
        or N(0, 0.02) draws from the trainer's seed."""
        for module in (self.unet, self.te):
            module.to(self.device).requires_grad_(False).eval()
        gen = torch.Generator().manual_seed(self.seed)
        dtype = self.param_dtype or torch.float32
        params = []
        for i, tok in enumerate(self.tokenizers):
            table = self._te_embedding_leaf(i)
            if self.initializer_token is not None:
                init_ids = tok.tokenize(self.initializer_token)
                if not init_ids:
                    raise ValueError(f"initializer token {self.initializer_token!r} tokenized to nothing")
                rows = table[init_ids[0]].float()[None].repeat(self.num_vectors, 1)
            else:
                rows = torch.randn((self.num_vectors, table.shape[-1]), generator=gen) * 0.02
            params.append((self._emb_key(i), nn.Parameter(rows.to(device=self.device, dtype=dtype))))
        return params

    # -- the loss -------------------------------------------------------

    def _loss_for_batch(self, batch: dict, draws: dict):
        """Grafted text encode (no stop-gradient on the context), the frozen
        UNet's forward, the loss; ``batch["tokenizer_outputs"]`` holds one
        ``{input_ids, attention_mask}`` per text model."""
        if "class_labels" in batch:
            raise ValueError("textual inversion needs a text-conditional model")
        x = self._put(batch["latent"] if "latent" in batch else batch["sample"])
        toks = [{k: torch.as_tensor(v).to(self.device) for k, v in t.items()} for t in batch["tokenizer_outputs"]]
        grafted = self._graft_te_params(dict(self.params))
        ctx, _, pooled, mask = functional_call(self.te, grafted, (toks,))
        added = self._added_cond(batch, pooled)
        return self.loss(
            x, lambda noisy, t: self.unet(noisy, t, ctx, mask, added), generator=self._gen,
            sample_weight=None if batch.get("loss_weight") is None else self._put(batch["loss_weight"]),
            **draws,
        )

    # -- export / inference ---------------------------------------------

    def grafted_te_params(self) -> dict:
        """The text encoders' state dict with the learned rows: load it
        into ``trainer.te`` (or a copy) and encode with ``trainer.tokenizers``,
        which expand the placeholder."""
        self.setup()
        with torch.no_grad():
            grafted = self._graft_te_params(dict(self.params))
        return {**self.te.state_dict(), **grafted}

    def export_embeddings(self, path: str) -> None:
        """The learned rows as an ``.npz``, fp32, keyed as the JAX trainer's
        ``export_params`` keys them (``['text_models_0']``, ...)."""
        self.setup()
        np.savez(path, **{f"['{name}']": p.detach().float().cpu().numpy() for name, p in self.params})
