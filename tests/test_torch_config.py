"""The port's config system and data layer against the JAX package's, on the CPU.

- The port's YAML reader gives what PyYAML's ``safe_load`` gives for every
  config file of the repo (one case a file), and refuses what lies outside
  its subset; the merged SDXL training configs equal the JAX package's
  merge.
- Config targets under ``uwudiff_tpu.`` resolve in the port, a missing one
  raising with its ROADMAP item; ``device`` and ``dtype`` reach the
  targets.
- The training CLI runs the tiny latent config to its end in a process
  where importing ``jax`` or ``uwudiff_tpu`` fails.
- ``DummyDataset``, ``DataLoader`` and ``TrainDataModule`` equal the JAX
  package's key by key: samples, tokenizer outputs, ``time_ids``, the batch
  order over three epochs and a resume from a mid-epoch ``state_dict``.
"""

import glob
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from uwudiff_tpu.config import load_config_files as jax_load_config_files
from uwudiff_tpu.config import merge_configs as jax_merge_configs
from uwudiff_tpu.data import DataLoader as JaxDataLoader
from uwudiff_tpu.data import DummyDataset as JaxDummyDataset
from uwudiff_tpu.data import TrainDataModule as JaxTrainDataModule
from uwudiff_tpu.models.tokenizers import SimpleTokenizer as JaxTokenizer
from uwudiff_tpu_torch.config import get_obj_from_str, instantiate_any, load_config_files, merge_configs
from uwudiff_tpu_torch.config._yaml import load_yaml
from uwudiff_tpu_torch.data import DataLoader, DummyDataset, TrainDataModule
from uwudiff_tpu_torch.models.tokenizers import SimpleTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                                                                recursive=True))
SDXL_CONFIGS = [os.path.join(ROOT, "configs", f) for f in ("demo_training_latent.yaml",
                                                            "demo_training_latent_sdxl.yaml")]


def _same(a, b) -> bool:
    """Equal values of equal types, key order included (NaN equals NaN)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_matches_pyyaml(path):
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    assert _same(load_yaml(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: 1\nb:\n  - x\n  - - 1\n    - 2\n  - {k: v, n: null, q: 'it''s # no comment'}\n",
    "a:\n- 1.0e-05\n- 1e-5\n- .5\n- -3\n- yes\n- ~\n- \"tab\\tq\"\n- [[1, 2], {x: [3]}]\n",
    "- a: 1\n  b:\n    c: true\n- plain words: with colon\n",
])
def test_yaml_reader_matches_pyyaml_on_the_subset(text):
    assert _same(load_yaml(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", ["a: &x 1\nb: *x\n", "a: |\n  x\n", "a: !!str 1\n", "---\na: 1\n",
                                  "a: [1,\n  2]\n", "a: 0x10\n", "a: 010\n", "a: 2001-12-14\n", "<<: {a: 1}\n"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError, match="subset"):
        load_yaml(text)


def test_sdxl_training_configs_merge_as_in_jax():
    ours = load_config_files(SDXL_CONFIGS)
    assert _same(ours, jax_load_config_files(SDXL_CONFIGS))
    overlay = {"run_config": {"max_steps": 3}, "trainer": {"model_config": {"vae": {"x": 1}}}, "seed": [1]}
    assert _same(merge_configs(ours, overlay), jax_merge_configs(ours, overlay))
    unet = ours["trainer"]["model_config"]["unet"]
    assert (unet["config"], unet["dtype"], unet["gradient_checkpointing"]) == ("sdxl", "bfloat16", True)


def test_targets_resolve_in_the_port_with_device_and_dtype():
    from uwudiff_tpu_torch.diffusion import NoiseSchedule, RectifiedFlowLoss
    from uwudiff_tpu_torch.models import UNet2DConditionModel

    assert get_obj_from_str("uwudiff_tpu.diffusion.NoiseSchedule.sdxl") == NoiseSchedule.sdxl
    loss = instantiate_any({"_target_": "uwudiff_tpu.diffusion.RectifiedFlowLoss",
                            "schedule": {"_target_": "uwudiff_tpu.diffusion.NoiseSchedule.sdxl"},
                            "time_sampling_type": "uniform_time"}, device="cpu")
    assert isinstance(loss, RectifiedFlowLoss) and loss.time_sampling_type == "uniform_time"
    unet = instantiate_any({"_target_": "uwudiff_tpu.models.UNet2DConditionModel.from_config", "config": "tiny",
                            "dtype": "bfloat16", "gradient_checkpointing": True}, device="cpu")
    assert isinstance(unet, UNet2DConditionModel) and unet.gradient_checkpointing
    assert unet.dtype == torch.bfloat16 and unet.conv_in.weight.device.type == "cpu"
    node = {"class": "uwudiff_tpu.models.UNet2DConditionModel", "factory": "from_config",
            "kwargs": {"config": "tiny", "device": "meta"}}
    assert instantiate_any(node, device="cpu").conv_in.weight.device.type == "meta"  # the node's own device wins
    with pytest.raises(NotImplementedError, match="item 13"):
        get_obj_from_str("uwudiff_tpu.data.AspectBucketDataset")
    with pytest.raises(NotImplementedError, match="item 11"):
        instantiate_any({"_target_": "uwudiff_tpu.models.UNet2DConditionModel.from_config", "config": "tiny",
                         "remat_policy": "save_names:attn_out"}, device="cpu")
    # the JAX load config's to_freeze, precision, device and to_compile have no
    # counterpart in the port: a node that sets one is refused
    from uwudiff_tpu_torch.loader import load_any

    with pytest.raises(TypeError, match="precision"):
        load_any({"_target_": "uwudiff_tpu.models.UNet2DConditionModel.from_config", "config": "tiny",
                  "_load_config_": {"precision": "bfloat16"}}, device="meta")


@pytest.fixture(autouse=True, scope="module")
def cli_run(tmp_path_factory):
    """The CLI over the repo's tiny latent config, in a process where the
    JAX package and JAX cannot be imported: started with the module, so that
    it runs beside the module's other tests; yields (process, stdout path,
    stderr path)."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = sys.modules['uwudiff_tpu'] = None\n"
            "import torch; torch.set_num_threads(1)\n"
            "sys.argv = ['train', '--configs', 'configs/demo_training_latent.yaml', '--device', 'cpu',"
            " '--fast-dev-run']\n"
            "runpy.run_module('uwudiff_tpu_torch.train', run_name='__main__')\n")
    logs = tmp_path_factory.mktemp("cli")
    with open(logs / "stdout", "w") as out, open(logs / "stderr", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=out, stderr=err, text=True,
                                env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        yield proc, logs / "stdout", logs / "stderr"
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def _dataset_pair(**kw):
    toks = ([JaxTokenizer(), JaxTokenizer()], [SimpleTokenizer(), SimpleTokenizer()])
    return JaxDummyDataset(tokenizers=toks[0], **kw), DummyDataset(tokenizers=toks[1], **kw)


def _assert_same_batch(jb: dict, tb: dict):
    assert list(jb) == list(tb)
    np.testing.assert_array_equal(tb["sample"], jb["sample"])
    assert tb["captions"] == jb["captions"]
    np.testing.assert_array_equal(tb["added_cond"]["time_ids"], jb["added_cond"]["time_ids"])
    assert len(tb["tokenizer_outputs"]) == len(jb["tokenizer_outputs"]) > 0
    for t, j in zip(tb["tokenizer_outputs"], jb["tokenizer_outputs"]):
        assert list(t) == list(j)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
            assert t[k].dtype == j[k].dtype
    for key in ("class_labels", "loss_mask"):
        if key in jb:
            np.testing.assert_array_equal(tb[key], jb[key])


@pytest.mark.parametrize("kw", [
    dict(sample_size=(8, 8, 4), n_samples=10, seed=3, caption="a red fox in snow"),
    dict(sample_size=(4, 6, 4), n_samples=7, n_classes=5, with_loss_mask=True, long_prompt_chunks=2),
])
def test_dummy_dataset_matches_jax(kw):
    jds, tds = _dataset_pair(**kw)
    assert len(jds) == len(tds)
    for i in range(len(jds)):
        j, t = jds[i], tds[i]
        assert list(j) == list(t)
        np.testing.assert_array_equal(t["sample"], j["sample"])
        np.testing.assert_array_equal(t["add_time_ids"], j["add_time_ids"])
        for tt, jt in zip(t["tokenizer_out"], j["tokenizer_out"]):
            for k in jt:
                np.testing.assert_array_equal(tt[k], jt[k])
        for key in ("class_label", "loss_mask"):
            if key in j:
                np.testing.assert_array_equal(t[key], j[key])
    _assert_same_batch(JaxDummyDataset.collate([jds[i] for i in (2, 0, 5)]), DummyDataset.collate([tds[i] for i in
                                                                                                     (2, 0, 5)]))


def test_loader_order_and_resume_match_jax():
    jds, tds = _dataset_pair(sample_size=(4, 4, 4), n_samples=11, seed=1)
    jl, tl = JaxDataLoader(jds, batch_size=3, seed=5), DataLoader(tds, batch_size=3, seed=5)
    assert len(jl) == len(tl) == 3
    ji, ti = iter(jl), iter(tl)
    for _ in range(3 * len(jl) + 1):  # three epochs and into the fourth
        _assert_same_batch(next(ji), next(ti))
        assert tl.state_dict() == jl.state_dict()
    # a fresh loader resumed mid-epoch yields what the unbroken one yields
    state = tl.state_dict()
    resumed = DataLoader(tds, batch_size=3, seed=5)
    resumed.load_state_dict(state)
    ri = iter(resumed)
    for _ in range(4):
        _assert_same_batch(next(ji), next(ri))
    # sharded orders and the last partial batch
    for shard in range(3):
        js = JaxDataLoader(jds, batch_size=2, seed=2, drop_last=False, shard_id=shard, num_shards=3)
        ts = DataLoader(tds, batch_size=2, seed=2, drop_last=False, shard_id=shard, num_shards=3)
        jbs, tbs = list(js.epoch_iter()), list(ts.epoch_iter())
        assert len(js) == len(ts) == len(jbs) == len(tbs)
        for jb, tb in zip(jbs, tbs):
            _assert_same_batch(jb, tb)
        assert ts.state_dict() == js.state_dict() == {"epoch": 1, "batch_idx": 0}


def test_data_module_matches_jax():
    cfg = dict(dataset_config={"_target_": "uwudiff_tpu.data.DummyDataset", "sample_size": [4, 4, 4],
                               "n_samples": 9},
               dataloader_config={"batch_size": 2, "seed": 0, "num_workers": 4},
               val_dataset_config={"_target_": "uwudiff_tpu.data.DummyDataset", "sample_size": [4, 4, 4],
                                   "n_samples": 5, "seed": 1})
    jdm, tdm = JaxTrainDataModule(**cfg), TrainDataModule(**cfg)
    jdm.set_tokenizers([JaxTokenizer()])
    tdm.set_tokenizers([SimpleTokenizer()])
    for jl, tl in ((jdm.train_dataloader(), tdm.train_dataloader()), (jdm.val_dataloader(), tdm.val_dataloader())):
        jbs, tbs = list(jl.epoch_iter()), list(tl.epoch_iter())
        assert (len(jl), jl.shuffle, len(jbs)) == (len(tl), tl.shuffle, len(tbs))
        for jb, tb in zip(jbs, tbs):
            _assert_same_batch(jb, tb)
    with pytest.raises(NotImplementedError, match="item 17"):
        TrainDataModule(cfg["dataset_config"], {"shard_per_process": True}).train_dataloader()


def test_cli_runs_the_tiny_config_without_jax(cli_run):
    """The CLI builds everything from the repo's tiny latent config in a
    process where the JAX package and JAX cannot be imported (last in the
    module: its process has run beside the other tests)."""
    proc, stdout, stderr = cli_run
    returncode = proc.wait(timeout=300)
    assert returncode == 0, stderr.read_text()[-4000:]
    assert stdout.read_text().strip().splitlines()[-1] == "done at step 1"
