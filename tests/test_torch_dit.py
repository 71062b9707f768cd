"""The port's DiT slice against the JAX package's, on the CPU, in fp32.

The ``tiny`` DiT (head dim 16) and a 2-block DiT 144 wide over 2 heads
(head dim 72, ``dit_xl_2``'s), with labels and ``learn_sigma`` on and off;
the label dropout of ``embed(train=True)``; ``load_jax_params`` of an
unscanned and a scanned tree; ``class_conditional_sampling`` (4 labels, 4
steps: CFG 4.0, CFG 1.0 as one conditional pass, and ``RFDenoiser`` on the
shifted RF ladder of ``configs/sampling/demo_sampling_dit.yaml``); the
training step's loss and every gradient against ``jax.value_and_grad`` of
the JAX ``DMTrainer`` loss, and one ``train_step`` in the ``dit_xl_2``
recipe's settings (``adamw``, global clip 1.0, fp32 masters under bf16
compute) at that width; the unported options raising.

Weights are ``test_torch_models.random_params`` draws (which fill the leaves
the JAX init zeroes), carried across by ``convert.load_jax_params``. JAX's
threefry draws cannot be made in torch, so the JAX side's draws are fed to
the port: the sampler's init and step noise, the loss's noise and
timesteps, and the label-dropout mask, read off the JAX ``embed``'s
conditioning (a dropped lane's is ``t_emb + label_embed[num_classes]``
exactly). Every JAX program is built once, with the suite's cheap compiler
settings (``FAST_COMPILE``), traced and compiled in background threads
(``jax_refs``) while the port runs. Each tolerance is stated at its test.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import FAST_COMPILE, random_params
from uwudiff_tpu.diffusion.losses import DiffusionLoss as JaxDiffusionLoss
from uwudiff_tpu.diffusion.schedules import NoiseSchedule as JaxSchedule
from uwudiff_tpu.models import dit as jdit
from uwudiff_tpu.parallel import batch_sharding, make_mesh
from uwudiff_tpu.sampling import get_sigmas as jsig
from uwudiff_tpu.sampling import sampling as jsampling_module
from uwudiff_tpu.sampling.sampling import class_conditional_sampling as jax_class_sampling
from uwudiff_tpu.sampling.wrapper import RFDenoiser as JaxRFDenoiser
from uwudiff_tpu.training import DMTrainer as JaxTrainer
from uwudiff_tpu_torch import sampling as tsampling
from uwudiff_tpu_torch.convert import load_jax_params, to_jax_params
from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule
from uwudiff_tpu_torch.models import DIT_PRESETS, DiT
from uwudiff_tpu_torch.sampling import sampling as tsampling_module
from uwudiff_tpu_torch.training import DMTrainer

D72 = dict(hidden_size=144, num_heads=2, depth=2)  # dit_xl_2's head dim, 2 blocks
LABELS = [0, 3, 7, 9]  # the sampling requests (tiny's 10 classes)
STEPS, RES, SEED = 4, 64, 1215  # 8x8 latents, 16 tokens
RF_SIGMAS = dict(max_sigma=14.6146, shift=3.0)  # configs/sampling/demo_sampling_dit.yaml
TRAIN_KW = dict(lr=1e-3, optimizer="adamw", opt_config={"weight_decay": 0.01, "betas": (0.9, 0.999)},
                use_warm_up=False, grad_clip=1.0, seed=0)


def _inputs(b=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 8, 8, 4)).astype(np.float32)
    t = rng.uniform(0, 999, b).astype(np.float32)
    labels = rng.integers(0, 10, b).astype(np.int32)
    return x, t, labels


def _jmodel(width, **kw):
    return jdit.DiT.from_config("tiny", **(D72 if width == "d72" else {}), **kw)


@functools.lru_cache(maxsize=None)
def _params(width, learn_sigma=False):
    x, t, labels = _inputs(1)
    port = DiT.from_config("tiny", device="cpu", **(D72 if width == "d72" else {}), learn_sigma=learn_sigma)
    return random_params(_jmodel(width, learn_sigma=learn_sigma), x, t, labels, seed=3 + learn_sigma, like=port)


def _port(width, params, **kw):
    model = DiT.from_config("tiny", device="cpu", **(D72 if width == "d72" else {}), **kw)
    return load_jax_params(model, params)


def _sampling_kw(kind):
    """The JAX entry point's keywords of a sampling case: CFG 4.0 or 1.0 on
    sd15's ladder, or RFDenoiser on the shifted RF ladder."""
    kw = dict(num_steps=STEPS, cfg_scale=1.0 if kind == "cfg1" else 4.0, seed=SEED, width=RES, height=RES,
              return_latents=True)
    if kind == "rf":
        kw.update(denoiser_cls=JaxRFDenoiser, get_sigma_func=functools.partial(
            jsig.get_sigmas_for_rf, max_sigma=RF_SIGMAS["max_sigma"],
            time_disc_func=functools.partial(jsig.shift_time, shift=RF_SIGMAS["shift"])))
    return kw


def _train_batch():
    rng = np.random.default_rng(5)
    return {"sample": rng.standard_normal((4, 8, 8, 4)).astype(np.float32),
            "class_labels": np.array([1, 4, 6, 8], np.int32), "tokenizer_outputs": []}


def _train_rng():
    return jax.random.PRNGKey(21)


@functools.lru_cache(maxsize=None)
def _jax_trainer():
    """The JAX trainer of the 144-wide DiT in the dit_xl_2 recipe's settings,
    fp32, label dropout 0.5 so that the batch of 4 drops some lanes."""
    jtr = JaxTrainer(model_config={"unet": _jmodel("d72", class_dropout_prob=0.5), "te": None, "vae": None},
                     loss_config=JaxDiffusionLoss(schedule=JaxSchedule.sd15()), **TRAIN_KW)
    jtr.mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])  # what setup builds, on one device
    jtr._batch_sh = batch_sharding(jtr.mesh)
    return jtr


class _Refs:
    """The module's JAX results by key: a program compiling in a background
    thread and the arguments it runs on, run on first use, or a background
    run of the sampling entry point."""

    def __init__(self):
        self.pending, self.done = {}, {}

    def __getitem__(self, key):
        if key not in self.done:
            future, args = self.pending.pop(key)
            result = future.result()
            self.done[key] = jax.device_get(result(*args)) if args is not None else result
        return self.done[key]


def _build_refs():
    """Every JAX program of the module, each traced here and compiled in a
    thread of its own (XLA's compile releases the interpreter lock, so the
    compiles run beside the tracing and the port), and the three runs of
    the sampling entry point, a thread each."""
    pool = ThreadPoolExecutor(10)
    refs = _Refs()

    def program(key, fn, *args, run=True):
        refs.pending[key] = (pool.submit(jax.jit(fn).lower(*args).compile, FAST_COMPILE), args if run else None)

    # (d) the sampling entry point, one run in a thread each
    jm_tiny, p_tiny = _jmodel("tiny"), _params("tiny")
    unet_fn = lambda p_, x_, t_, l_: jm_tiny.apply({"params": p_}, x_, t_, l_)  # noqa: E731
    for kind in ("cfg4", "cfg1", "rf"):
        schedule = JaxSchedule.sdxl() if kind == "rf" else JaxSchedule.sd15()
        refs.pending["sample", kind] = (pool.submit(lambda kw, schedule=schedule: np.asarray(jax_class_sampling(
            unet_fn, schedule, LABELS, 10, unet_params=p_tiny, **kw)), _sampling_kw(kind)), None)
    # (a) the forwards
    x, t, labels = _inputs()
    for width in ("tiny", "d72"):
        for learn_sigma in (False, True):
            jm = _jmodel(width, learn_sigma=learn_sigma)
            program(("fwd", width, learn_sigma), lambda p_, jm=jm: jm.apply({"params": p_}, x, t, labels),
                    _params(width, learn_sigma))
    # (b) embed's conditioning with label dropout (0.5, 8 lanes), and without
    jm, p = _jmodel("d72", class_dropout_prob=0.5), _params("d72")
    xb, tb, lb = _inputs(8, seed=1)

    def embeds(p_, key):
        kw = dict(method=jm.embed)
        return (jm.apply({"params": p_}, xb, tb, lb, train=True, rngs={"dropout": key}, **kw)[1],
                jm.apply({"params": p_}, xb, tb, lb, **kw)[1],
                jm.apply({"params": p_}, xb, tb, jnp.full_like(lb, 10), **kw)[1])

    program("embed", embeds, p, jax.random.PRNGKey(4))
    # (e) the trainer's loss and gradients, and the update of given gradients
    jtr = _jax_trainer()

    def loss_and_grads(p_, b_, key_):
        return jax.value_and_grad(lambda q: jtr._loss_for_batch(q, {}, b_, key_), has_aux=True)(p_)

    program("train", loss_and_grads, p, jtr._put_batch(_train_batch()), _train_rng())

    def update(grads, p_):
        return optax.apply_updates(p_, jtr.tx.update(grads, jtr.tx.init(p_), p_)[0])

    program("update", update, p, p, run=False)
    pool.shutdown(wait=False)  # the threads end with their work
    return refs


class _FastJitJax:
    """``jax`` as the JAX sampling module sees it while this module runs:
    its ``jax.jit`` of the whole sampling loop compiles with FAST_COMPILE."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kw):
        return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


@pytest.fixture(scope="module")
def jax_refs():
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jsampling_module, "jax", _FastJitJax())
        yield _build_refs()


@pytest.mark.parametrize("learn_sigma", [False, True])
@pytest.mark.parametrize("width", ["tiny", "d72"])
def test_dit_forward_matches_jax(jax_refs, width, learn_sigma):
    """The forward with labels, fp32: within 1e-5 of the output's largest
    element (fp32 sums in another order through two blocks)."""
    x, t, labels = _inputs()
    model = _port(width, _params(width, learn_sigma), learn_sigma=learn_sigma)
    assert model.blocks_0.hidden_size // model.blocks_0.num_heads == (72 if width == "d72" else 16)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(labels)).numpy()
    want = np.asarray(jax_refs["fwd", width, learn_sigma])
    assert out.shape == want.shape == (2, 8, 8, 8 if learn_sigma else 4) and out.dtype == np.float32
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(out, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_label_dropout_takes_the_jax_mask(jax_refs):
    """``embed(train=True)``: the JAX side's mask, read off its conditioning
    (a dropped lane equals the null class's, bitwise), given to the port as
    ``drop_mask``, gives the same conditioning within 1e-5 of its largest;
    without a mask the port draws from its generator, and the same seed
    draws the same mask."""
    dropped, kept, null = (np.asarray(a) for a in jax_refs["embed"])
    is_null = (dropped == null).all(axis=1)
    assert ((dropped == kept).all(axis=1) | is_null).all() and 0 < is_null.sum() < 8  # every lane kept or dropped
    model = _port("d72", _params("d72"), class_dropout_prob=0.5)
    xb, tb, lb = (torch.from_numpy(a) for a in _inputs(8, seed=1))
    with torch.no_grad():
        _, c = model.embed(xb, tb, lb, train=True, drop_mask=torch.from_numpy(is_null))
        np.testing.assert_allclose(c.numpy(), dropped, atol=1e-5 * np.abs(dropped).max(), rtol=0)
        draws = [model.embed(xb, tb, lb, train=True, generator=torch.Generator().manual_seed(9))[1] for _ in range(2)]
        assert torch.equal(*draws)
        _, c_eval = model.embed(xb, tb, lb)
    np.testing.assert_allclose(c_eval.numpy(), kept, atol=1e-5 * np.abs(kept).max(), rtol=0)


def test_load_jax_params_takes_a_scanned_tree_and_refuses_a_mismatch():
    """The scanned tree (``scan_blocks=True``: one ``blocks`` subtree, its
    leaves stacked on a leading layer axis, as the JAX init shapes it) loads
    into the same parameters as the unscanned one; a missing or mis-shaped
    leaf raises. The port's tree round-trips through ``to_jax_params``."""
    params = _params("d72")
    scanned = {k: v for k, v in params.items() if not k.startswith("blocks_")}
    scanned["blocks"] = jax.tree_util.tree_map(lambda *xs: np.stack(xs), params["blocks_0"], params["blocks_1"])
    x, t, labels = _inputs(1)
    shapes = jax.eval_shape(lambda: _jmodel("d72", scan_blocks=True).init(jax.random.PRNGKey(0), x, t, labels))
    want = jax.tree_util.tree_map(lambda a: a.shape, shapes["params"])
    assert jax.tree_util.tree_map(np.shape, scanned) == want
    a, b = _port("d72", params), _port("d72", scanned)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    back = to_jax_params(a)
    assert jax.tree_util.tree_map(np.shape, back) == jax.tree_util.tree_map(np.shape, params)
    missing = {k: v for k, v in params.items() if k != "label_embed"}
    with pytest.raises(KeyError, match="label_embed"):
        _port("d72", missing)
    wrong = dict(params, patch_embed={"kernel": np.zeros((2, 2, 4, 72), np.float32),
                                      "bias": params["patch_embed"]["bias"]})
    with pytest.raises(ValueError, match="patch_embed"):
        _port("d72", wrong)
    stacked_wrong = dict(scanned, blocks=jax.tree_util.tree_map(lambda a: a[:1], scanned["blocks"]))
    with pytest.raises(ValueError, match="layer axes"):
        _port("d72", stacked_wrong)


def _jax_sampling_draws(kind):
    """The JAX entry point's draws: its key split into (init, sampler), the
    init noise of the batch, and Euler-ancestral's step noise, one split of
    the sampler's key a step; with the ladder the steps are keyed by."""
    if kind == "rf":
        sigmas = np.asarray(jsig.get_sigmas_for_rf(STEPS, max_sigma=RF_SIGMAS["max_sigma"], time_disc_func=(
            functools.partial(jsig.shift_time, shift=RF_SIGMAS["shift"]))), np.float32)
    else:
        sigmas = np.asarray(JaxSchedule.sd15().sample_sigmas_descending(STEPS), np.float32)
    _, rng_init, rng_samp = jax.random.split(jax.random.PRNGKey(SEED), 3)
    shape = (len(LABELS), RES // 8, RES // 8, 4)
    init = np.asarray(jax.random.normal(rng_init, shape))
    steps = []
    for _ in range(STEPS):
        rng_samp, sub = jax.random.split(rng_samp)
        steps.append(np.asarray(jax.random.normal(sub, shape)))
    return sigmas, init, steps


@pytest.mark.parametrize("kind", ["cfg4", "cfg1", "rf"])
def test_class_conditional_sampling_matches_jax(jax_refs, kind, monkeypatch):
    """Four labels, four Euler-ancestral steps with the JAX side's draws fed
    to the port: the latents within 1e-4 of their largest (fp32 through
    four steps of the tiny DiT). CFG 4.0 runs the doubled batch [labels,
    null] once a step; CFG 1.0 one conditional pass of 4."""
    sigmas, init, steps = _jax_sampling_draws(kind)
    monkeypatch.setattr(tsampling_module, "per_sample_init_noise", lambda *a, **k: torch.from_numpy(init.copy()))
    monkeypatch.setattr(tsampling_module, "make_per_sample_noise_sampler", lambda *a, **k: (
        lambda shape, s, s_next: torch.from_numpy(steps[int(np.argmin(np.abs(sigmas[:-1] - s)))].copy())))
    model = _port("tiny", _params("tiny"))
    calls = []

    def unet_fn(m, x, t, labels):
        calls.append(labels.tolist())
        return m(x, t, labels)

    kw = _sampling_kw(kind)
    if kind == "rf":
        kw.update(denoiser_cls=tsampling.RFDenoiser, get_sigma_func=functools.partial(
            tsampling.get_sigmas_for_rf, max_sigma=RF_SIGMAS["max_sigma"],
            time_disc_func=functools.partial(tsampling.shift_time, shift=RF_SIGMAS["shift"])))
    schedule = NoiseSchedule.sdxl() if kind == "rf" else NoiseSchedule.sd15()
    lat = tsampling.class_conditional_sampling(unet_fn, schedule, LABELS, 10, unet_params=model, device="cpu", **kw)
    want = jax_refs["sample", kind]
    assert lat.shape == want.shape == (4, 8, 8, 4)
    assert np.isfinite(lat.numpy()).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(lat.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)
    step_labels = LABELS if kind == "cfg1" else LABELS + [10] * 4
    assert calls == [step_labels] * STEPS


def test_class_conditional_sampling_refuses_latent_sharding():
    with pytest.raises(NotImplementedError, match="latent_sharding"):
        tsampling.class_conditional_sampling(None, NoiseSchedule.sd15(), LABELS, 10, latent_sharding=object(),
                                             device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_train_draws():
    """The JAX loss's draws for the training key: split into (encode, loss,
    dropout), the loss's into (time, noise)."""
    jloss = _jax_trainer().loss
    rng_t, rng_n = jax.random.split(jax.random.split(_train_rng(), 3)[1])
    x = _train_batch()["sample"]
    return dict(noise=np.array(jloss.sample_noise(rng_n, jnp.asarray(x))),
                timesteps=np.array(jloss.sample_timesteps_and_sigmas(rng_t, x.shape[0])[0]))


@functools.lru_cache(maxsize=None)
def _drop_mask():
    """The label-dropout mask of the JAX trainer's key, read off the JAX
    ``embed`` of the batch under its dropout key (split's third): a dropped
    lane's conditioning is the null class's, bitwise."""
    jm, p = _jmodel("d72", class_dropout_prob=0.5), _params("d72")
    b = _train_batch()
    x, labels, t = b["sample"], b["class_labels"], np.zeros(4, np.float32)
    key = jax.random.split(_train_rng(), 3)[2]
    c = np.asarray(jm.apply({"params": p}, x, t, labels, train=True, rngs={"dropout": key}, method=jm.embed)[1])
    null = np.asarray(jm.apply({"params": p}, x, t, np.full_like(labels, 10), method=jm.embed)[1])
    return (c == null).all(axis=1)


def _port_trainer(**kw):
    return DMTrainer({"unet": _port("d72", _params("d72"), class_dropout_prob=0.5), "te": None, "vae": None},
                     loss_config=DiffusionLoss(schedule=NoiseSchedule.sd15()), device="cpu", **TRAIN_KW, **kw)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def test_training_loss_and_gradients_match_jax(jax_refs):
    """The fp32 loss over the batch and every gradient against
    ``jax.value_and_grad`` of the JAX trainer's loss, given its noise,
    timesteps and label-drop mask (some lanes dropped): the loss within
    1e-5 relative, each gradient within 1e-4 of its leaf's largest plus
    1e-6 of the tree's largest (fp32 sums in another order through two
    blocks; the k projection's bias has a zero gradient in exact arithmetic,
    softmax ignoring a shift of a row's logits, so both sides hold only
    rounding there, ~1e-9)."""
    draws, mask = _jax_train_draws(), _drop_mask()
    assert 0 < mask.sum() < 4
    tr = _port_trainer()
    loss, aux = tr.forward_backward(_train_batch(), drop_mask=mask, **draws)
    grads = to_jax_params(tr.unet, {n: p.grad for n, p in tr.params})
    (want_loss, want_aux), want_grads = jax_refs["train"]
    np.testing.assert_allclose(aux.target.numpy(), draws["noise"], atol=1e-6)
    np.testing.assert_allclose(np.asarray(want_aux.target), draws["noise"], atol=1e-6)  # the draws JAX made
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got, want = dict(_flat(grads)), dict(_flat(want_grads))
    assert set(got) == set(want)
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(got[name], w, atol=1e-4 * np.abs(w).max() + floor, rtol=0, err_msg=name)


def test_recipe_step_updates_fp32_masters_as_optax_adamw(jax_refs):
    """One ``train_step`` in the dit_xl_2 recipe's settings at this width:
    the forward and backward in bf16 over fp32 masters, then ``adamw`` with
    the global clip 1.0. Each master's change equals optax's clip + adamw
    update of the same (widened) gradients within two fp32 steps of the
    leaf's largest parameter (fp32 arithmetic in another order; the leaves'
    gradients rounded to bf16 share it); the module holds the masters' bf16
    rounding; the loss is within 2e-2 of the fp32 JAX loss (bf16 compute)."""
    draws = _jax_train_draws()
    tr = _port_trainer(compute_dtype="bfloat16")
    grads = {}
    apply_updates = tr.apply_updates

    def capture(sr_bits=None):
        grads.update({n: p.grad.detach().float().clone() for n, p in tr.params})
        return apply_updates(sr_bits)

    tr.apply_updates = capture
    metrics, _ = tr.train_step(_train_batch(), drop_mask=_drop_mask(), **draws)
    assert all(p.dtype == torch.bfloat16 for _, p in tr.params)
    masters = tr.master_weights()
    assert all(m.dtype == torch.float32 for m in masters.values())
    assert all(torch.equal(p.detach(), masters[n].to(torch.bfloat16)) for n, p in tr.params)
    p0 = _params("d72")
    want = dict(_flat(jax.device_get(jax_refs["update"](to_jax_params(tr.unet, grads), p0))))
    got = dict(_flat(to_jax_params(tr.unet, masters)))
    start = dict(_flat(p0))
    assert float(metrics["train/grad_norm"]) > 1.0  # the clip acts
    for name, w in want.items():
        tol = 2 * 2.0**-23 * np.abs(start[name]).max()
        np.testing.assert_allclose(got[name], w, atol=tol, rtol=0, err_msg=name)
        assert not np.array_equal(got[name], start[name]), name
    (want_loss, _), _ = jax_refs["train"]
    np.testing.assert_allclose(float(metrics["train/loss"]), float(want_loss), rtol=2e-2)


@pytest.mark.parametrize("option", ["num_experts", "use_rope", "scan_blocks", "preset_tiny_moe"])
def test_unported_options_raise(option):
    if option == "preset_tiny_moe":
        assert DIT_PRESETS["tiny_moe"]["num_experts"] == 4
        with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
            DiT.from_config("tiny_moe", device="cpu")
        return
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        DiT(**DIT_PRESETS["tiny"], **{option: 4 if option == "num_experts" else True})
