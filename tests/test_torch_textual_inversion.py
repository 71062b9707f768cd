"""The port's SD3 textual-inversion path against the JAX package, on the CPU, in fp32.

The tiny stack of the SD3 configuration: two tiny CLIPs in bucket 0 (both
pooled, ``layer_idx=-2``), a tiny T5 in bucket 1 at 256 tokens with its
key mask, ``pad_context_to``, a tiny MMDiT with SD3's switches on, and
``RectifiedFlowLoss(logit_normal)``. Weights are ``random_params`` draws,
which fill the leaves the JAX init zeroes (adaLN-Zero, the final
projection): with those at zero no gradient reaches the text context.
The JAX trainer is built once per file, its state assembled from the
same trees its ``setup`` would build (as ``test_torch_train_step.py``
does). JAX's draws (noise, the logit-normal z) are recomputed from its
keys and handed to the port. JAX's row gradients are read back from its
Adam first moment (``mu_k = 0.9 mu_{k-1} + 0.1 g_k``, after global-norm
clipping), which costs no second compile of the step, and the JAX
programs are compiled with LLVM's cheap settings
(``test_torch_models.compile_fast``).

Tolerances: token ids exact; encoder outputs and the loss within 1e-5 of
their scale (fp32 sums in another order); row gradients within 1e-4 of
their largest element (a backward through three encoders and the MMDiT);
row updates within 1e-3 of the largest update (Adam divides by
sqrt(v) + 1e-8, which magnifies a gradient's rounding where it is small).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import assert_close, compile_fast, random_params
from uwudiff_tpu.diffusion import NoiseSchedule as JaxSchedule
from uwudiff_tpu.diffusion import RectifiedFlowLoss as JaxRFLoss
from uwudiff_tpu.models.mmdit import MMDiT as JaxMMDiT
from uwudiff_tpu.models.text_encoders import ConcatTextEncoders as JaxConcat
from uwudiff_tpu.models.tokenizers import SimpleTokenizer as JaxTokenizer
from uwudiff_tpu.parallel import batch_sharding, make_mesh
from uwudiff_tpu.training.textual_inversion import TextualInversionTrainer as JaxTI
from uwudiff_tpu.training.trainer import TrainState
from uwudiff_tpu_torch.convert import load_jax_params
from uwudiff_tpu_torch.diffusion import NoiseSchedule, RectifiedFlowLoss
from uwudiff_tpu_torch.models import ConcatTextEncoders, MMDiT, SimpleTokenizer
from uwudiff_tpu_torch.training import TextualInversionTrainer

B, T5_LEN, PAD_TO = 2, 256, 80
CAPTIONS = ["a photo of <concept>", "<Concept>, a watercolour of a lighthouse at dusk"]
TE_CFGS = [
    ({"model_type": "clip", "preset": "tiny"}, {"use_pooled": True, "layer_idx": -2}),
    ({"model_type": "clip", "preset": "tiny"}, {"use_pooled": True, "layer_idx": -2}),
    ({"model_type": "t5", "preset": "tiny"},
     {"concat_bucket": 1, "use_pooled": False, "layer_idx": -1, "need_mask": True}),
]
MMDIT_CFG = dict(context_dim=PAD_TO, pooled_dim=64, depth=2, context_pre_only=True, pos_embed_max_size=16,
                 pos_embed_base_size=8)
TRAINER_KW = dict(lr=5e-3, optimizer="adamw", use_warm_up=False, placeholder_token="<concept>", num_vectors=2,
                  seed=0)


def _toks(tokenizer_cls):
    return [tokenizer_cls(), tokenizer_cls(), tokenizer_cls(model_max_length=T5_LEN)]


@functools.lru_cache(maxsize=None)
def _stack():
    """(JAX trainer, its frozen params, initial rows, batch): built once."""
    loss = JaxRFLoss(schedule=JaxSchedule.sdxl(), time_sampling_type="logit_normal")
    jte = JaxConcat.from_config(TE_CFGS, zero_for_padding=False, pad_context_to=PAD_TO)
    jmm = JaxMMDiT.from_config("tiny", **MMDIT_CFG)
    jtr = JaxTI(model_config={"unet": jmm, "te": jte, "vae": None, "tokenizers": _toks(JaxTokenizer)},
                loss_config=loss, **TRAINER_KW)
    rng = np.random.default_rng(0)
    batch = {"latent": rng.standard_normal((B, 8, 8, 4)).astype(np.float32),
             "tokenizer_outputs": [tok(CAPTIONS) for tok in jtr.tokenizers]}
    te_params = random_params(jtr.te, batch["tokenizer_outputs"], seed=1)
    ctx = np.zeros((B, 77 + T5_LEN, PAD_TO), np.float32)
    mask = np.ones((B, 77 + T5_LEN), np.int32)
    unet_params = random_params(jmm, batch["latent"], np.zeros(B, np.float32), ctx, mask,
                                {"text_embeds": np.zeros((B, 64), np.float32)}, seed=2)
    rows = {f"text_models_{i}": (0.02 * rng.standard_normal((2, 32))).astype(np.float32) for i in range(3)}
    frozen = {"te": te_params, "unet": unet_params}
    # what TextualInversionTrainer.setup builds, on one device
    jtr.mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jtr._batch_sh = batch_sharding(jtr.mesh)
    jtr.frozen = frozen
    jrows = jax.tree_util.tree_map(jnp.asarray, rows)
    jtr.state = jax.device_put(TrainState(step=jnp.zeros((), jnp.int32), params=jrows,
                                          opt_state=jax.jit(jtr.tx.init)(jrows),
                                          ema_loss=jnp.zeros((), jnp.float32)), jax.devices()[0])
    jtr._train_step = compile_fast(jtr._train_step_impl, jtr.state, frozen, jtr._put_batch(batch),
                                jax.random.PRNGKey(TRAINER_KW["seed"]), donate_argnums=0)
    jtr._built = True
    return jtr, frozen, rows, batch


def _port_trainer(frozen, **kw):
    te = ConcatTextEncoders.from_config(TE_CFGS, device="cpu", zero_for_padding=False, pad_context_to=PAD_TO)
    mm = MMDiT.from_config("tiny", device="cpu", **MMDIT_CFG)
    loss = RectifiedFlowLoss(schedule=NoiseSchedule.sdxl(), time_sampling_type="logit_normal")
    tr = TextualInversionTrainer({"unet": mm, "te": te, "vae": None, "tokenizers": _toks(SimpleTokenizer)},
                                 loss_config=loss, device="cpu", **{**TRAINER_KW, **kw})
    load_jax_params(tr.te, frozen["te"])  # the enlarged tables, as the JAX trainer's
    load_jax_params(tr.unet, frozen["unet"])
    return tr


def _jax_draws(step):
    """The noise and logit-normal z of the JAX trainer's step ``step``:
    PRNGKey(seed) folded with the step, split for (encode, loss), the loss
    key split for (time, noise)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(TRAINER_KW["seed"]), step)
    _, rng_loss = jax.random.split(rng)
    rng_t, rng_n = jax.random.split(rng_loss)
    return (np.array(jax.random.normal(rng_n, (B, 8, 8, 4), jnp.float32)),
            np.array(jax.random.normal(rng_t, (B,))))


def test_placeholder_ids_match_jax():
    texts = ["a photo of <concept>", "<CONCEPT>, in snow", "two <concept><concept> cats", "sks tasks sks.",
             "no placeholder here", ""]
    for max_length in (77, 256):
        jt, tt = JaxTokenizer(model_max_length=max_length), SimpleTokenizer(model_max_length=max_length)
        for tok in (jt, tt):
            tok.add_placeholder("<Concept>", [1024, 1025])
            tok.add_placeholder("sks", [1026])
        for text in texts:
            assert tt.tokenize(text) == jt.tokenize(text), text
        for key, arr in jt(texts).items():
            np.testing.assert_array_equal(tt(texts)[key], arr)
    assert tt.tokenize("a photo of <concept>")[-2:] == [1024, 1025]
    assert tt.tokenize("sks tasks") == [1026, tt._word_id("tasks")]


def test_clip_clip_t5_context_and_mask_match_jax():
    jtr, frozen, _, batch = _stack()
    toks = batch["tokenizer_outputs"]
    ref = compile_fast(jtr.te.apply, {"params": frozen["te"]}, toks)({"params": frozen["te"]}, toks)
    te = ConcatTextEncoders.from_config(TE_CFGS, device="cpu", zero_for_padding=False, pad_context_to=PAD_TO)
    for i in range(3):  # the trainer's enlarged tables and pinned CLIP eos id
        tm = te.get_submodule(f"text_models_{i}")
        tm.token_embedding.weight = torch.nn.Parameter(torch.zeros(tm.token_embedding.num_embeddings + 2, 32))
        tm.token_embedding.num_embeddings += 2
        if i < 2:
            tm.eos_token_id = jtr.te.text_models[i].eos_token_id
    load_jax_params(te, frozen["te"])
    with torch.no_grad():
        out = te([{k: torch.from_numpy(v) for k, v in t.items()} for t in toks])
    emb, normed, pooled, mask = out
    assert emb.shape == (B, 77 + T5_LEN, PAD_TO) and pooled.shape == (B, 64)
    for got, want in zip((emb, normed, pooled), ref[:3]):
        assert_close(got, want)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref[3]))
    assert mask[:, :77].all() and mask[0, 77:].sum() == len(toks[2]["input_ids"][0].nonzero()[0])


@pytest.mark.parametrize("kind", ["uniform_time", "logit_normal", "uniform_timestep"])
def test_rectified_flow_loss_matches_jax(kind):
    jloss = JaxRFLoss(schedule=JaxSchedule.sdxl(), time_sampling_type=kind)
    loss = RectifiedFlowLoss(schedule=NoiseSchedule.sdxl(), time_sampling_type=kind)
    x = np.random.default_rng(3).standard_normal((4, 8, 8, 4)).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    rng_t, rng_n = jax.random.split(rng)
    noise = np.array(jax.random.normal(rng_n, x.shape, jnp.float32))
    draws = np.array({"uniform_time": lambda: jax.random.uniform(rng_t, (4,)),
                      "logit_normal": lambda: jax.random.normal(rng_t, (4,)),
                      "uniform_timestep": lambda: jax.random.randint(rng_t, (4,), 0, 1000)}[kind]())

    def model_fn(xt, t):  # eps prediction (the sdxl schedule's type), converted to the RF target
        return 0.5 * xt + 1e-3 * t.reshape(-1, 1, 1, 1)

    jl, jaux = jloss(rng, jnp.asarray(x), model_fn)
    tl, taux = loss(torch.from_numpy(x), model_fn, noise=torch.from_numpy(noise),
                    time_draws=torch.from_numpy(draws))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(taux.timesteps.numpy(), np.asarray(jaux.timesteps), rtol=1e-5)
    for name in ("target", "pred", "noisy_latent", "losses"):
        assert_close(getattr(taux, name), getattr(jaux, name))


def test_two_ti_steps_match_jax():
    """Loss, grad norm, row gradients and rows after each of two steps;
    the frozen text encoders and MMDiT unchanged."""
    jtr, frozen, rows, batch = _stack()
    tr = _port_trainer(frozen)
    assert [t.added_tokens["<concept>"] for t in tr.tokenizers] == [[1024, 1025]] * 3
    assert tr.te.text_models_0.eos_token_id == 2 == jtr.te.text_models[0].eos_token_id
    tr.setup()
    assert [n for n, _ in tr.params] == ["text_models_0", "text_models_1", "text_models_2"]
    with torch.no_grad():
        for name, p in tr.params:
            p.copy_(torch.from_numpy(rows[name]))
    frozen_before = {n: t.clone() for m in (tr.te, tr.unet) for n, t in m.state_dict().items()}
    grads = []
    apply_updates = tr.apply_updates

    def capture(sr_bits=None):
        grads.append({n: p.grad.detach().clone() for n, p in tr.params})
        return apply_updates(sr_bits)

    tr.apply_updates = capture
    prev, prev_mu = rows, {n: 0.0 for n in rows}
    for step in range(2):
        jm, jaux = jtr.train_step(batch)
        noise, z = _jax_draws(step)
        np.testing.assert_allclose(noise - batch["latent"], np.asarray(jaux.target), atol=1e-6)
        m, aux = tr.train_step(batch, noise=noise, time_draws=z)
        np.testing.assert_allclose(float(m["train/loss"]), float(jm["train/loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["train/grad_norm"]), float(jm["train/grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(aux.timesteps.numpy(), np.asarray(jaux.timesteps), rtol=1e-5)
        jp = jax.device_get(jtr.state.params)
        mu = {n: np.asarray(v, np.float64) for n, v in jtr.state.opt_state[1][0].mu.items()}
        unclip = max(float(jm["train/grad_norm"]), 1.0)  # clip_by_global_norm(1.0) scaled g by 1/norm
        for name, p in tr.params:
            want = (mu[name] - np.float32(0.9) * prev_mu[name]) / np.float32(0.1) * unclip
            assert np.abs(want).max() > 0, name
            np.testing.assert_allclose(grads[step][name].numpy(), want, atol=1e-4 * np.abs(want).max(),
                                       rtol=0, err_msg=name)
            jd, td = np.asarray(jp[name]) - prev[name], p.detach().numpy() - prev[name]
            np.testing.assert_allclose(td, jd, atol=1e-3 * np.abs(jd).max(), rtol=0, err_msg=name)
        prev, prev_mu = {n: np.asarray(v) for n, v in jp.items()}, mu
    for n, t in {n: t for m in (tr.te, tr.unet) for n, t in m.state_dict().items()}.items():
        assert torch.equal(t, frozen_before[n]), n
    assert all(not p.requires_grad for m in (tr.te, tr.unet) for p in m.parameters())


def test_initializer_token_warm_start_matches_jax():
    jtr, frozen, _, batch = _stack()
    jtr2 = copy.copy(jtr)
    jtr2.initializer_token = "cat"
    jrows, _ = jtr2._select_trainable_params(frozen["unet"], {"te": frozen["te"]}, batch, None,
                                             jax.random.PRNGKey(0))
    tr = _port_trainer(frozen, initializer_token="cat")
    tr.setup()
    for name, p in tr.params:
        assert p.shape == (2, 32) and p.dtype == torch.float32
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jrows[name]))
    grafted = tr.grafted_te_params()
    table = grafted["text_models_2.token_embedding.weight"]
    assert table.shape == (1026, 32) and torch.equal(table[1024:], tr.params[2][1].detach())
    with pytest.raises(ValueError, match="text encoder|te"):
        TextualInversionTrainer({"unet": tr.unet, "te": None}, device="cpu")


def test_export_embeddings_load_in_the_jax_package(tmp_path):
    """The learned rows' ``.npz`` loads into the JAX trainer's row tree."""
    from uwudiff_tpu.training.checkpoint import load_params_npz

    _, frozen, rows, _ = _stack()
    tr = _port_trainer(frozen)
    tr.setup()
    path = tmp_path / "rows.npz"
    tr.export_embeddings(str(path))
    loaded = load_params_npz(str(path), rows)
    for name, p in tr.params:
        np.testing.assert_array_equal(np.asarray(loaded[name]), p.detach().numpy())


def test_pooled_only_tower_adds_its_pooled_vector_alone():
    """``pooled_only``: the tower's pooled vector joins the pooled concat,
    its sequence stays out of the context (and its mask out of the mask)."""
    cfgs = [({"model_type": "clip", "preset": "tiny"}, {"use_pooled": True}),
            ({"model_type": "clip", "preset": "tiny"}, {"use_pooled": True, "pooled_only": True, "need_mask": True}),
            ({"model_type": "t5", "preset": "tiny"}, {"use_pooled": False, "need_mask": True})]
    torch.manual_seed(0)
    te = ConcatTextEncoders.from_config(cfgs, device="cpu")
    tok = SimpleTokenizer()
    toks = [{k: torch.from_numpy(v) for k, v in tok(c).items()} for c in (CAPTIONS, ["a", "b c"], CAPTIONS)]
    with torch.no_grad():
        emb, _, pooled, mask = te(toks)
        alone = te.text_models_1(toks[1]["input_ids"], toks[1]["attention_mask"])
    assert emb.shape == (B, 77, 64) and pooled.shape == (B, 64) and mask.shape == (B, 77)
    torch.testing.assert_close(pooled[:, 32:], alone.pooler_output, rtol=0, atol=0)
    torch.testing.assert_close(mask, toks[2]["attention_mask"].int(), rtol=0, atol=0)  # the T5's, not tower 1's


def test_entry_points_raise_without_cuda(monkeypatch):
    from uwudiff_tpu_torch.models import T5EncoderModel
    from uwudiff_tpu_torch.training.bench_setup import build_ti_trainer_and_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (build_ti_trainer_and_batch, lambda: T5EncoderModel.from_config("tiny"),
                  lambda: MMDiT.from_config("tiny")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    te = ConcatTextEncoders.from_config(TE_CFGS[:1], device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TextualInversionTrainer({"unet": MMDiT.from_config("tiny", device="cpu"), "te": te})
