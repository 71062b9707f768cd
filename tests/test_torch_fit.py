"""The port's training surface against the JAX package's, on the CPU, in fp32.

The repo's tiny latent config (``configs/demo_training_latent.yaml``: the
``tiny`` UNet, a tiny CLIP encoded inside the step, ``RectifiedFlowLoss``
with ``uniform_time``) with the SDXL overlay's optimizer (``adamw_factored``,
weight decay 0.01; its leaves factored down to 16 wide, so that the tiny
model's leaves take the factored path), caption dropout 0.5 and small
latents with a loss mask, built through each package's config system.

- One ``DMTrainer`` step against the JAX ``_train_step_impl`` (its
  timesteps, noise and caption-dropout mask handed to the port) and
  ``validation_step`` against ``_val_step_impl`` from the same state and
  draws: loss, grad norm and every updated leaf within
  ``test_torch_train_step.py``'s fp32 tolerance; the tiny config's own
  global clip of 1.0 stays on, as in that test (without it the first
  step's update of a dense leaf, g / sqrt(g^2 + 1e-8), turns the fp32
  gradients' summation-order differences, ~1e-5 of a leaf's largest, into
  up to ~40 % of the update of an element whose gradient is near 1e-4:
  3.7e-6 against a largest change of 1.2e-4 on one conv bias). The JAX
  program is traced and compiled once, in a thread from the module's
  start; the other tests run while it compiles.
- ``gradient_checkpointing``: the loss and every gradient bitwise those
  without it.
- ``fit`` for 6 steps against 3 steps and a fresh trainer resuming to 6
  (three epochs): the whole state, the loader's and the logged losses of
  steps 4-6 bitwise; a save that fails part way leaves the earlier step.
- ``export_params`` read by the JAX ``load_params_npz``, and a JAX
  ``save_params_npz`` file read by the port's ``apply_load_config``,
  bitwise.
- The callbacks against the JAX ones on the same values;
  ``Txt2ImgPipeline.from_trainer`` against a pipeline built by hand over the
  same modules, bitwise.
"""

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import FAST_COMPILE, random_params
from uwudiff_tpu.config import instantiate_any as jax_instantiate_any
from uwudiff_tpu.parallel import make_mesh
from uwudiff_tpu.training.callbacks import LogAdditionalLosses as JaxLogAdditionalLosses
from uwudiff_tpu.training.callbacks import PlotValLossPerTimestep as JaxPlotValLossPerTimestep
from uwudiff_tpu.training.checkpoint import load_params_npz as jax_load_params_npz
from uwudiff_tpu.training.checkpoint import save_params_npz as jax_save_params_npz
from uwudiff_tpu.training.trainer import TrainState
from uwudiff_tpu_torch.config import instantiate_any, load_config_files, merge_configs
from uwudiff_tpu_torch.convert import load_jax_params, to_jax_params
from uwudiff_tpu_torch.diffusion import DiffusionLossAux
from uwudiff_tpu_torch.loader import ModelLoadConfig, apply_load_config
from uwudiff_tpu_torch.models import SimpleTokenizer, TextEncodingPipeline, UNet2DConditionModel
from uwudiff_tpu_torch.sampling.wrapper import RFDenoiser
from uwudiff_tpu_torch.serving import Txt2ImgPipeline
from uwudiff_tpu_torch.training import CheckpointManager, LogAdditionalLosses, PlotValLossPerTimestep, SampleImages
from uwudiff_tpu_torch.training import checkpoint as port_checkpoint
from uwudiff_tpu_torch.training.profiling import check_finite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "demo_training_latent.yaml")
SEED = 3
VAL_INDEX = 1
OVERLAY = {
    "seed": SEED,
    "data": {"dataset_config": {"sample_size": [8, 8, 4], "n_samples": 10, "with_loss_mask": True},
             "dataloader_config": {"batch_size": 4, "seed": 0}},
    "trainer": {"lr": 1e-3, "use_warm_up": False, "optimizer": "adamw_factored",
                "opt_config": {"weight_decay": 0.01, "min_dim_size_to_factor": 16}, "caption_dropout": 0.5,
                "seed": SEED},
}


def _config(**over):
    return merge_configs(load_config_files([TINY]), OVERLAY, over)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def _strip(batch):
    return {k: v for k, v in batch.items() if k not in ("captions", "cross_attention_kwargs")}


def _port(config=None, params=None):
    """(port trainer, data module) of ``config`` on the CPU; with ``params``
    ((unet tree, te tree)) the JAX package's weights."""
    config = config or _config()
    torch.manual_seed(0)
    tr = instantiate_any(dict(config["trainer"]), device="cpu")
    dm = instantiate_any(config["data"], device="cpu")
    if params is not None:
        load_jax_params(tr.unet, params[0])
        load_jax_params(tr.te, params[1])
    return tr, dm


def _first_batch(tr, dm):
    dm.set_tokenizers(tr.tokenizers)
    return next(iter(dm.train_dataloader()))


def _jax_reference(lowered: threading.Event):
    """The JAX side of the step test: the tiny config's trainer, its weights
    drawn on the port's trees, one ``_train_step_impl`` and one
    ``_val_step_impl`` from the same state, and both steps' draws, in one
    program; on the host. ``lowered`` is set once the program is traced."""
    config = _config()
    # the port's modules, for their trees' shapes, built on the CPU under a
    # forked generator: the tests share torch's and wait while this runs
    # (the meta device would import torch._dynamo here, ~2.5 s)
    model = config["trainer"]["model_config"]
    with torch.random.fork_rng(devices=[]):
        unet, te = (instantiate_any(model[k], device="cpu") for k in ("unet", "te"))
    dm = instantiate_any(config["data"])
    dm.set_tokenizers([SimpleTokenizer()])
    batch = _strip(next(iter(dm.train_dataloader())))
    jtr = jax_instantiate_any(dict(config["trainer"]))
    toks = [{k: v[:1] for k, v in t.items()} for t in batch["tokenizer_outputs"]]
    x = batch["sample"][:1]
    te_params = random_params(jtr.te, toks, seed=1, like=te)
    unet_params = random_params(jtr.unet, x, np.zeros((1,), np.float32), np.zeros((1, 77, 32), np.float32),
                                seed=2, like=unet)
    jtr.mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    frozen = {"te": te_params}

    def draws(rng):  # _loss_for_batch's keys: encode (its caption dropout), loss (time, noise)
        rng_enc, rng_loss, _ = jax.random.split(rng, 3)
        _, rng_cdrop = jax.random.split(rng_enc)
        rng_t, rng_n = jax.random.split(rng_loss)
        b = batch["sample"].shape[0]
        return (jax.random.bernoulli(rng_cdrop, jtr.caption_dropout, (b,)), jax.random.uniform(rng_t, (b,)),
                jax.random.normal(rng_n, batch["sample"].shape, jnp.float32))

    def run(params, frozen, batch):
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=jtr.tx.init(params),
                           ema_loss=jnp.zeros((), jnp.float32))
        key = jax.random.PRNGKey(SEED)
        new_state, metrics, aux = jtr._train_step_impl(state, frozen, batch, key)
        # validation from the same state with the step's own key: the same
        # draws, so the JAX program shares the forward's compile
        val_loss, val_aux = jtr._val_step_impl(state, frozen, batch, jax.random.fold_in(key, 0))
        return new_state.params, metrics, aux.losses, val_loss, val_aux.losses, draws(jax.random.fold_in(key, 0))

    program = jax.jit(run).lower(unet_params, frozen, batch)
    lowered.set()
    out = jax.device_get(program.compile(FAST_COMPILE)(unet_params, frozen, batch))
    return (unet_params, te_params), out


@pytest.fixture(autouse=True, scope="module")
def jax_reference():
    """The JAX program, traced, compiled and run in a thread of its own from
    the module's start; the other tests start once it is traced (the
    tracing is Python, and would share the interpreter lock with them;
    XLA's compile releases it), and the step test reads it last."""
    lowered = threading.Event()
    with ThreadPoolExecutor(1) as pool:
        result = pool.submit(_jax_reference, lowered)
        while not lowered.wait(1.0) and not result.done():
            pass
        yield result


@pytest.mark.parametrize("size", [(8, 4), (16, 24), (12, 10), (5, 3)])
def test_loss_mask_pools_to_the_latent_grid_as_jax(size):
    """Latent-sized, integer-multiple and resized masks (``[B, H, W]`` and
    ``[B, H, W, 1]``) against the JAX trainer's ``_pool_mask_to``."""
    from uwudiff_tpu.training.trainer import _pool_mask_to as jax_pool
    from uwudiff_tpu_torch.training.trainer import _pool_mask_to

    m = (np.random.default_rng(6).random((2, *size, 1)) > 0.5).astype(np.float32)
    for mask in (m, m[..., 0]):
        want = np.asarray(jax_pool(jnp.asarray(mask), (8, 4)))
        got = _pool_mask_to(torch.from_numpy(mask), (8, 4)).numpy()
        assert got.shape == want.shape == (2, 8, 4)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_remat_is_bitwise_the_plain_step():
    """The tiny UNet's loss and every gradient with each ResnetBlock2D and
    Transformer2DModel recomputed in the backward are those without."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, 32)).astype(np.float32))
    t = torch.tensor([10.5, 731.0])
    torch.manual_seed(0)
    plain = UNet2DConditionModel.from_config("tiny", device="cpu")
    remat = UNet2DConditionModel.from_config("tiny", device="cpu", gradient_checkpointing=True)
    remat.load_state_dict(plain.state_dict())
    results = []
    for model in (plain, remat):
        loss = model(x, t, ctx).square().mean()
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()}))
    torch.testing.assert_close(results[1][0], results[0][0], rtol=0, atol=0)
    assert results[0][1].keys() == results[1][1].keys()
    for name, g in results[0][1].items():
        assert g is not None and torch.equal(results[1][1][name], g), name
    with torch.no_grad():  # no recompute outside autograd
        assert torch.equal(remat(x, t, ctx), plain(x, t, ctx))


FIT = {"trainer": {"ema_weights_decay": 0.999}}  # the weight EMA rides the checkpoint too


def _fit(tmp_path, name, max_steps, resume=False, **kw):
    tr, dm = _port(_config(**FIT))
    tr.fit(dm, max_steps=max_steps, log_dir=str(tmp_path / name / "log"), log_every=100,
           ckpt_dir=str(tmp_path / name / "ckpt"), ckpt_every=3, ckpt_keep=1, resume_from=resume, **kw)
    with open(tmp_path / name / "log" / "metrics.jsonl") as f:
        logged = {r["step"]: r["train/loss"] for r in map(json.loads, f)}
    return tr, logged


def test_fit_resumes_bitwise(tmp_path, monkeypatch):
    """6 steps unbroken against 3 steps, then a fresh trainer that resumes to
    6: the data (10 samples, batches of 4) crosses two epoch boundaries."""
    whole, whole_log = _fit(tmp_path, "whole", 6, profile_dir=str(tmp_path / "trace"), profile_steps=(1, 2))
    assert [f for f in os.listdir(tmp_path / "trace") if f.endswith(".json")]  # steps 2-3 traced
    _fit(tmp_path, "split", 3)
    tr, dm = _port(_config(**FIT))
    tr.setup()
    ptrs = {k: v.data_ptr() for k, v in tr.state_dict().items() if k not in ("step", "opt_state/count")}
    tr.fit(dm, max_steps=6, log_dir=str(tmp_path / "split" / "log"), log_every=100,
           ckpt_dir=str(tmp_path / "split" / "ckpt"), ckpt_every=3, ckpt_keep=1, resume_from=True)
    resumed = tr
    with open(tmp_path / "split" / "log" / "metrics.jsonl") as f:
        resumed_log = {r["step"]: r["train/loss"] for r in map(json.loads, f)}
    assert resumed.step == whole.step == 6
    want, got = whole.state_dict(), resumed.state_dict()
    assert want.keys() == got.keys() and any(k.startswith("ema_params/") for k in want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    moved = [k for k, p in got.items() if k not in ("step", "opt_state/count", "ema_loss")
             and k.startswith(("params/", "opt_state/", "ema_params/")) and p.data_ptr() != ptrs[k]]
    assert not moved, moved[:4]  # the restore copied into the live tensors
    assert sorted(resumed_log) == list(range(1, 7))  # steps 1-3 before the break, 4-6 after it
    for step in (4, 5, 6):
        assert resumed_log[step] == whole_log[step]
    mgr = CheckpointManager(str(tmp_path / "split" / "ckpt"), keep=1)
    assert mgr.all_steps() == [6]
    _, data_state = mgr.restore()  # the loader's state at the end, as the unbroken run's
    assert data_state == CheckpointManager(str(tmp_path / "whole" / "ckpt")).restore()[1] == {"epoch": 2,
                                                                                               "batch_idx": 2}

    # a save that fails part way through writing leaves the last whole step
    def broken_write(path, tensors):
        with open(path, "wb") as f:
            f.write(b"\0" * 64)
        raise OSError("disk full")

    monkeypatch.setattr(port_checkpoint, "write_safetensors", broken_write)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(9, resumed.state_dict(), {"epoch": 4, "batch_idx": 1})
    assert mgr.latest_step() == 6 and sorted(os.listdir(mgr.directory)) == ["6"]
    state, _ = mgr.restore()
    for key in want:
        assert torch.equal(state[key], got[key]), key
    assert bool(check_finite(got))

    # sampling the weight EMA writes it into the UNet for the call only
    held = {n: p.detach().clone() for n, p in resumed.params}
    cb = SampleImages(prompts=["a red fox"], num_steps=2, width=32, height=32, use_ema=True)
    cb.on_fit_end(resumed, 6, _Recorder())
    assert cb.last_output.shape == (1, 4, 4, 4) and np.isfinite(cb.last_output).all()
    assert all(torch.equal(p, held[n]) for n, p in resumed.params)


def test_sample_images_of_a_class_conditional_trainer():
    from uwudiff_tpu_torch.models import DiT
    from uwudiff_tpu_torch.training import DMTrainer

    torch.manual_seed(0)
    tr = DMTrainer({"unet": DiT.from_config("tiny", device="cpu")}, device="cpu")
    tr.setup()
    cb = SampleImages(class_labels=[1, 7], num_steps=2, width=32, height=32, cfg_scale=4.0)
    cb.on_fit_end(tr, 3, _Recorder())
    assert cb.last_output.shape == (2, 4, 4, 4) and bool(torch.isfinite(cb.last_output).all())
    assert tr.unet.training


def test_params_npz_round_trips_with_jax(tmp_path):
    tr, _ = _port()
    tree = to_jax_params(tr.unet)
    # the port's export, read by the JAX loader into the JAX UNet's tree
    tr.export_params(str(tmp_path / "port.npz"))
    target = jax.tree_util.tree_map(np.zeros_like, tree)
    read = jax_load_params_npz(str(tmp_path / "port.npz"), target)
    got, want = dict(_flat(read)), dict(_flat(tree))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # a JAX export of bf16 parameters (stored as fp32), read by the port's loader
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a * 1.5, jnp.bfloat16), tree)
    jax_save_params_npz(str(tmp_path / "jax.npz"), jtree)
    torch.manual_seed(5)
    unet = UNet2DConditionModel.from_config("tiny", device="cpu")
    apply_load_config(unet, ModelLoadConfig(ckpt_path=str(tmp_path / "jax.npz")))
    ref = load_jax_params(UNet2DConditionModel.from_config("tiny", device="cpu"),
                          jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jtree))
    for (name, p), (_, q) in zip(unet.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(p, q), name
    # strict=False keeps the module's value for a leaf the file lacks
    partial = {k: v for k, v in jtree.items() if k != "conv_out"}
    jax_save_params_npz(str(tmp_path / "part.npz"), partial)
    with pytest.raises(KeyError, match="conv_out"):
        apply_load_config(unet, ModelLoadConfig(ckpt_path=str(tmp_path / "part.npz")))
    kept = unet.conv_out.weight.detach().clone()
    apply_load_config(unet, ModelLoadConfig(ckpt_path=str(tmp_path / "part.npz"), strict=False,
                                            param_dtype="bfloat16"))
    assert unet.dtype == torch.bfloat16 and torch.equal(unet.conv_out.weight, kept.bfloat16())


class _Recorder:
    def __init__(self):
        self.scalars, self.images = [], []

    def log_scalars(self, step, scalars):
        self.scalars.append((step, dict(scalars)))

    def log_image(self, step, name, image):
        self.images.append((step, name, np.asarray(image)))


def test_callbacks_match_jax():
    rng = np.random.default_rng(4)
    jcb, tcb = JaxLogAdditionalLosses(["losses", "timesteps"]), LogAdditionalLosses(["losses", "timesteps"])
    jlog, tlog = _Recorder(), _Recorder()
    for step in range(1, 5):
        losses = rng.random(6).astype(np.float32)
        timesteps = rng.uniform(0, 1000, 6).astype(np.float32)
        jaux = DiffusionLossAux(jnp.asarray(losses), jnp.asarray(timesteps), None, None, None)
        taux = DiffusionLossAux(torch.from_numpy(losses), torch.from_numpy(timesteps), None, None, None)
        jcb.on_train_batch_end(None, step, {}, jaux, jlog)
        tcb.on_train_batch_end(None, step, {}, taux, tlog)
    assert tlog.scalars == jlog.scalars and tcb.state_dict() == jcb.state_dict()

    jplot, tplot = JaxPlotValLossPerTimestep(n_bins=10), PlotValLossPerTimestep(n_bins=10)
    for cb in (jplot, tplot):
        cb.on_validation_start(None)
    for _ in range(3):
        losses = rng.random(8).astype(np.float32)
        timesteps = rng.uniform(0, 1000, 8).astype(np.float32)
        jplot.on_validation_batch_end(None, DiffusionLossAux(jnp.asarray(losses), jnp.asarray(timesteps),
                                                             None, None, None))
        tplot.on_validation_batch_end(None, DiffusionLossAux(torch.from_numpy(losses),
                                                             torch.from_numpy(timesteps), None, None, None))
    for got, want in zip(tplot.compute(), jplot.compute()):
        np.testing.assert_array_equal(got, want)
    jlog, tlog = _Recorder(), _Recorder()
    jplot.on_validation_end(None, 7, jlog)
    tplot.on_validation_end(None, 7, tlog)
    assert [(s, n) for s, n, _ in tlog.images] == [(s, n) for s, n, _ in jlog.images] == [(7, "val/loss_per_timestep")]
    np.testing.assert_array_equal(tlog.images[0][2], jlog.images[0][2])


def test_from_trainer_samples_the_trainers_modules():
    tr, dm = _port()
    tr.setup()
    pipe = Txt2ImgPipeline.from_trainer(tr)
    assert pipe.unet is tr.unet and pipe.te.module is tr.te and pipe.denoiser_cls is RFDenoiser
    assert pipe.te.tokenizers == tr.tokenizers
    kw = dict(prompt=["a red fox", "snow"], num_steps=3, num_samples=2, cfg_scale=4.0, width=64, height=64,
              seed=11, return_latents=True)
    got = pipe(**kw)
    assert tr.unet.training  # sampled in eval mode, back in train mode after
    by_hand = Txt2ImgPipeline(tr.unet, TextEncodingPipeline(tr.te, tr.tokenizers, device="cpu"), None,
                              schedule=tr.loss.schedule, device="cpu", denoiser_cls=RFDenoiser)
    want = by_hand(**kw)
    assert got.shape == (2, 8, 8, 4) and np.isfinite(got).all() and np.array_equal(got, want)
    cb = SampleImages(prompts=["a red fox", "snow"], num_steps=2, width=64, height=64, every_steps=2)
    cb.on_train_batch_end(tr, 2, {}, None, _Recorder())
    assert cb.last_output.shape == (2, 8, 8, 4) and tr.unet.training


def test_train_and_validation_step_match_jax(jax_reference):
    params, (jparams, jm, jlosses, jval, jval_losses, draws) = jax_reference.result()
    tr, dm = _port(params=params)
    batch = _first_batch(tr, dm)
    drop, time_draws, noise = draws
    assert 0 < drop.sum() < len(drop)  # the caption dropout's mask has both kinds of row
    assert 0 < batch["loss_mask"].mean() < 1  # the loss is masked
    val_loss, val_aux = tr.validation_step(batch, index=VAL_INDEX, noise=noise, time_draws=time_draws,
                                           drop_mask=drop)
    np.testing.assert_allclose(float(val_loss), float(jval), rtol=1e-5)
    np.testing.assert_allclose(val_aux.losses.numpy(), jval_losses, rtol=1e-5)
    p0 = dict(_flat(to_jax_params(tr.unet)))
    m, aux = tr.train_step(batch, noise=noise, time_draws=time_draws, drop_mask=drop)
    for key in ("train/loss", "train/grad_norm", "train/ema_loss", "train/lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(aux.losses.detach().numpy(), jlosses, rtol=1e-5)
    jp, tp = dict(_flat(jparams)), dict(_flat(to_jax_params(tr.unet)))
    assert jp.keys() == tp.keys()
    rel = []
    for name in jp:
        jd, td = jp[name] - p0[name], tp[name] - p0[name]
        assert np.abs(jd).max() > 0, name
        tol = 2.0**-8 * np.abs(jd).max() + 2.0**-22 * np.abs(jp[name]).max()
        np.testing.assert_allclose(td, jd, atol=tol, rtol=0, err_msg=name)
        rel.append(np.abs(td - jd).max() / np.abs(jd).max())
    assert np.median(rel) <= 1e-4, np.median(rel)
