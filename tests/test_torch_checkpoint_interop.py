"""Checkpoints across the two packages, and the port's launcher flags, on
the CPU.

- **Reference -> port**: ``tmlauncher`` (``theanompi_tpu.launcher``) on a
  one-device mesh trains the tiny Wide-ResNet (BatchNorm state) and the
  tiny ``TransformerLM`` two epochs with ``--checkpoint-dir`` and
  ``checkpoint_async=False``.  A directory holding its epoch 0 alone
  resumes in the port's launcher (``--resume``, ``--device cpu``), which
  trains epoch 1 and writes ``ckpt_e0001.npz``: every leaf (params, state,
  optimizer state) equal to the reference's uninterrupted epoch 1 at
  rtol 1e-5 / atol 1e-6 (the Wide-ResNet's atol relative to the leaf's
  largest value, ``SCALE`` of ``tests/test_torch_convnets.py``), the data
  plane's position and the manifest's fingerprint equal.
- **Port -> reference**: the same the other way round, held to the port's
  uninterrupted run.
- **``zero1`` at four ranks** against the reference's four-device mesh, in
  both directions: the port's ``--devices 4`` (4 gloo ranks) resumes the
  reference's global buckets, each rank cutting its slice, and the
  reference resumes the port's gathered buckets; the epoch-1 buckets held
  as above.
- For the same ``--set`` flags, ``model_fingerprint`` is equal in the two
  packages for ``TransformerLM``, ``WideResNet`` and ``ResNet50`` (the
  port's ``TransformerLM`` config once lacked three of the reference's
  keys and carried two of its own).
- The port's launcher end to end: ``--config-json``, ``--record-dir``,
  ``--checkpoint-dir`` then ``--resume`` bit-equal to an uninterrupted
  run; exit 77 on an exhausted chain, 78 on another run's checkpoint and
  0 with ``--resume-force``, on one rank and on two; the mid-epoch cadence
  (``checkpoint_every_n_iters=1``) resumed inside epoch 1 consumes the
  uninterrupted run's batches and ends on its params.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from theanompi_tpu.launcher import _parse_kv as ref_parse_kv
from theanompi_tpu.launcher import main as tm_main
from theanompi_tpu.models.resnet50 import ResNet50 as JaxResNet50
from theanompi_tpu.models.transformer_lm import TransformerLM as JaxLM
from theanompi_tpu.models.wide_resnet import WideResNet as JaxWRN
from theanompi_tpu.utils.checkpoint import model_fingerprint as ref_fp

from theanompi_torch import BSP
from theanompi_torch.launcher import _parse_kv
from theanompi_torch.launcher import main as port_main
from theanompi_torch.models.resnet50 import ResNet50
from theanompi_torch.models.transformer_lm import TransformerLM
from theanompi_torch.models.wide_resnet import WideResNet
from theanompi_torch.tree import tree_leaves_with_path
from theanompi_torch.utils import checkpoint as C

from chip_smoke import flip_leaf_byte

RTOL, ATOL = 1e-5, 1e-6
#: name -> (module, class, config, atol relative to a leaf's largest value)
MODELS = {
    "wrn": ("wide_resnet", "WideResNet",
            {"depth": 10, "widen": 1, "batch_size": 8, "image_size": 16,
             "n_train": 8, "n_val": 8, "precision": "fp32", "lr": 0.01},
            1e-5),
    "transformer": ("transformer_lm", "TransformerLM",
                    {"n_layers": 2, "dim": 64, "heads": 2, "seq_len": 64,
                     "batch_size": 2, "dropout": 0.0, "precision": "fp32",
                     "n_train": 8, "n_val": 4, "lr": 0.05, "vocab": 256,
                     "attn_impl": "blockwise"}, 0.0),
}
#: the reference's ``EXCHANGE_TINY`` (``tests/conftest.py:184``): per-rank
#: batch 2, one step an epoch at four ranks
ZERO1 = ("wide_resnet", "WideResNet",
         {"depth": 10, "widen": 1, "batch_size": 2, "image_size": 8,
          "n_train": 8, "n_val": 16, "precision": "fp32", "augment": False,
          "lr": 0.05}, 1e-5)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _sets(cfg: dict, n_epochs: int) -> list:
    return [a for k, v in {**cfg, "n_epochs": n_epochs}.items()
            for a in ("--set", f"{k}={v!r}")]


def _ref(spec, ck, n_epochs, devices=1, extra=()):
    mod, cls, cfg, _ = spec
    return tm_main(["--devices", str(devices), "--modelfile",
                    f"theanompi_tpu.models.{mod}", "--modelclass", cls,
                    "--quiet", "--checkpoint-dir", str(ck), "--rule-set",
                    "checkpoint_async=False", *_sets(cfg, n_epochs),
                    *extra])


def _port(spec, ck, n_epochs, devices=1, extra=()):
    mod, cls, cfg, _ = spec
    return port_main(["--devices", str(devices), "--device", "cpu",
                      "--modelfile", f"theanompi_torch.models.{mod}",
                      "--modelclass", cls, "--quiet", "--checkpoint-dir",
                      str(ck), "--rule-set", "checkpoint_async=False",
                      *_sets(cfg, n_epochs), *extra])


def _epoch0_of(src, dst) -> str:
    """A checkpoint directory holding ``src``'s epoch 0 alone."""
    os.makedirs(dst)
    for f in ("ckpt_e0000.npz", "ckpt_e0000.manifest.json"):
        shutil.copy(os.path.join(src, f), dst)
    man = C.read_manifest(os.path.join(dst, "ckpt_e0000.npz"))
    with open(os.path.join(dst, "latest.json"), "w") as f:
        json.dump({"epoch": 0, "iteration": man["iteration"]}, f)
    return str(dst)


def _assert_same_state(got_dir, want_dir, scale, epoch=1):
    """Epoch ``epoch``'s checkpoint of ``got_dir`` against ``want_dir``'s:
    the same leaves within the tolerance, the same data state and
    manifest fingerprint and iteration."""
    name = f"ckpt_e{epoch:04d}.npz"
    got, want = (np.load(os.path.join(d, name)) for d in (got_dir, want_dir))
    with got, want:
        assert set(got.files) == set(want.files)
        assert any(k.startswith("opt_state::") for k in want.files)
        for k in want.files:
            g, w = got[k], want[k]
            assert (g.dtype, g.shape) == (w.dtype, w.shape), k
            if k == C.DATA_STATE_LEAF or g.dtype.kind in "iu":
                np.testing.assert_array_equal(g, w, err_msg=k)
                continue
            atol = max(ATOL, scale * float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol,
                                       err_msg=k)
    mg, mw = (C.read_manifest(os.path.join(d, name))
              for d in (got_dir, want_dir))
    for key in ("epoch", "iteration", "lr_scale", "fingerprint",
                "data_state"):
        assert mg[key] == mw[key], key


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """Each model's two epochs in each package: name -> (reference dir,
    port dir)."""
    out = {}
    for name, spec in MODELS.items():
        d = tmp_path_factory.mktemp(name)
        assert _ref(spec, d / "ref", 2) == 0
        assert _port(spec, d / "port", 2) == 0
        out[name] = (str(d / "ref"), str(d / "port"))
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_reference_to_port(tmp_path, uninterrupted, name):
    ref_dir, _ = uninterrupted[name]
    ck = _epoch0_of(ref_dir, tmp_path / "ck")
    assert _port(MODELS[name], ck, 2, extra=["--resume"]) == 0
    _assert_same_state(ck, ref_dir, MODELS[name][3])


@pytest.mark.parametrize("name", list(MODELS))
def test_port_to_reference(tmp_path, uninterrupted, name):
    _, port_dir = uninterrupted[name]
    ck = _epoch0_of(port_dir, tmp_path / "ck")
    assert _ref(MODELS[name], ck, 2, extra=["--resume"]) == 0
    _assert_same_state(ck, port_dir, MODELS[name][3])


@pytest.fixture(scope="module")
def zero1_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero1")
    z1 = ["--rule-set", "exch_strategy='zero1'"]
    assert _ref(ZERO1, d / "ref", 2, devices=4, extra=z1) == 0
    assert _port(ZERO1, d / "port", 2, devices=4, extra=z1) == 0
    return str(d / "ref"), str(d / "port"), z1


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_zero1_four_ranks(tmp_path, zero1_runs, direction):
    ref_dir, port_dir, z1 = zero1_runs
    with np.load(os.path.join(port_dir, "ckpt_e0000.npz")) as z:
        buckets = [k for k in z.files if k.startswith("opt_state::velocity/")]
        # the global buckets, as the reference keeps them
        with np.load(os.path.join(ref_dir, "ckpt_e0000.npz")) as r:
            assert buckets and all(z[k].shape == r[k].shape
                                   for k in buckets)
    if direction == "ref_to_port":
        src, want, resume = ref_dir, ref_dir, _port
    else:
        src, want, resume = port_dir, port_dir, _ref
    ck = _epoch0_of(src, tmp_path / "ck")
    assert resume(ZERO1, ck, 2, devices=4, extra=[*z1, "--resume"]) == 0
    _assert_same_state(ck, want, ZERO1[3])


FP_FLAGS = {
    "TransformerLM": (TransformerLM, JaxLM, ["dim=512", "heads=8",
                                             "n_layers=8", "seq_len=2048",
                                             "vocab=32768", "dropout=0.0",
                                             "batch_size=16", "lr=0.05"]),
    "WideResNet": (WideResNet, JaxWRN, ["depth=10", "widen=1",
                                        "batch_size=8", "image_size=16",
                                        "precision='fp32'"]),
    "ResNet50": (ResNet50, JaxResNet50, ["batch_size=256",
                                         "shard_size=256", "n_train=2048",
                                         "stage_blocks=(3, 4, 6, 3)",
                                         "stem='conv7'"]),
}


@pytest.mark.parametrize("model", list(FP_FLAGS))
def test_model_fingerprint_equal_across_packages(model):
    mine, ref, flags = FP_FLAGS[model]
    m, r = mine(_parse_kv(flags)), ref(ref_parse_kv(flags))
    assert C.model_fingerprint(m) == ref_fp(r)
    # n_epochs and verbose stay out of the sha, as the reference's
    assert C.model_fingerprint(mine(_parse_kv(flags + ["n_epochs=7"]))) \
        == C.model_fingerprint(m)


TINY_LM = ("transformer_lm", "TransformerLM",
           {"n_layers": 1, "dim": 16, "heads": 2, "seq_len": 16,
            "vocab": 32, "batch_size": 4, "n_train": 16, "n_val": 4,
            "precision": "fp32", "dropout": 0.0}, 0.0)


def test_launcher_config_json_record_dir_checkpoint_and_resume(tmp_path):
    mod, cls, cfg, _ = TINY_LM
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"model": {**cfg, "n_epochs": 9},
                                "rule": {"print_freq": 2}}))

    def run(ck, n_epochs, *extra):
        return port_main(["--device", "cpu", "--quiet", "--config-json",
                          str(conf), "--set", f"n_epochs={n_epochs}",
                          "--checkpoint-dir", str(tmp_path / ck),
                          "--rule-set", "checkpoint_async=False", *extra])

    assert run("A", 2, "--record-dir", str(tmp_path / "rec")) == 0
    assert {"time_history.npy", "train_history.npy", "val_history.npy",
            "summary.json"} <= set(os.listdir(tmp_path / "rec"))
    assert run("B", 1) == 0
    assert run("B", 2, "--resume") == 0
    a, b = (np.load(tmp_path / d / "ckpt_e0001.npz") for d in "AB")
    with a, b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
    assert ((tmp_path / "A" / "ckpt_e0001.manifest.json").read_bytes()
            == (tmp_path / "B" / "ckpt_e0001.manifest.json").read_bytes())
    val = np.load(tmp_path / "B" / "val_history.npy",
                  allow_pickle=True).item()
    assert list(val["epoch"]) == [0, 1]
    assert not os.path.exists(tmp_path / "B" / "dirty")  # a clean exit
    # the config file's errors are config errors
    assert port_main(["--device", "cpu", "--config-json",
                      str(tmp_path / "missing.json")]) == 78


def test_launcher_exits_77_78_and_forces(tmp_path, capsys):
    spec = TINY_LM
    assert _port(spec, tmp_path / "ck", 1) == 0
    bad = _epoch0_of(tmp_path / "ck", tmp_path / "bad")
    flip_leaf_byte(os.path.join(bad, "ckpt_e0000.npz"))
    assert _port(spec, bad, 2, extra=[
        "--resume", "--rule-set", "checkpoint_verify='full'"]) == 77
    assert "tmlauncher: error: checkpoint:" in capsys.readouterr().err
    assert os.listdir(os.path.join(bad, "corrupt"))
    # another model config: refused, then forced
    other = ["--resume", "--set", "lr=0.5"]
    assert _port(spec, tmp_path / "ck", 2, extra=other) == 78
    assert "fingerprint mismatch" in capsys.readouterr().err
    assert _port(spec, tmp_path / "ck", 2,
                 extra=other + ["--resume-force"]) == 0


def test_two_ranks_agree_on_77_and_78(tmp_path):
    mod, cls, cfg, _ = TINY_LM
    spec = (mod, cls, {**cfg, "batch_size": 2}, 0.0)
    assert _port(spec, tmp_path / "ck", 1, devices=2) == 0
    assert _port(spec, tmp_path / "ck", 2, devices=2,
                 extra=["--resume", "--set", "lr=0.5"]) == 78
    flip_leaf_byte(os.path.join(tmp_path / "ck", "ckpt_e0000.npz"))
    assert _port(spec, tmp_path / "ck", 2, devices=2, extra=[
        "--resume", "--rule-set", "checkpoint_verify='full'"]) == 77


#: the cadence cases: model, config, steps an epoch, the iteration whose
#: step is killed.  The token stream's cursors advance when an epoch's
#: generator is exhausted, which the prefetcher's producer does ``prefetch``
#: (2) batches ahead of training: killed inside the last two batches of
#: epoch 1, and killed at epoch 1's first step after a boundary save made
#: while epoch 1's producer had already run through its two batches.
CADENCE = {
    "wrn": (MODELS["wrn"][:3], 4, 6),
    "stream_mid_epoch": (TINY_LM[:2] + ({**TINY_LM[2],
                                         "dataset": "stream"},), 4, 6),
    "stream_boundary": (TINY_LM[:2] + ({**TINY_LM[2], "dataset": "stream",
                                        "n_train": 8},), 2, 2),
}


@pytest.mark.parametrize("case", list(CADENCE))
def test_mid_epoch_cadence_resumes_the_same_batches(tmp_path, case):
    (mod, cls, cfg), steps, killed = CADENCE[case]
    cfg = {**cfg, "n_train": steps * cfg["batch_size"]}
    seen = []

    def trainer(tag, crash=False, **rule):
        tr = BSP({"verbose": False, "checkpoint_every_n_iters": 1,
                  "checkpoint_async": False,
                  "checkpoint_dir": str(tmp_path / tag), **rule}).init(
            devices=1, modelfile=f"theanompi_torch.models.{mod}",
            modelclass=cls, model_config={**cfg, "n_epochs": 2},
            device="cpu").trainer
        real = tr.train_iter

        def spy(batch, lr):
            seen.append((tag, tr.epoch, np.asarray(batch["y"]).tobytes()))
            if crash and tr.iteration == killed:
                raise RuntimeError("killed inside epoch 1")
            return real(batch, lr)

        tr.train_iter = spy
        return tr

    whole = trainer("whole")
    whole.run()
    with pytest.raises(RuntimeError, match="killed"):
        trainer("crash", crash=True).run()
    cursor = killed - steps
    saved = C.read_manifest(str(tmp_path / "crash" / (
        "ckpt_e0001.npz" if cursor else "ckpt_e0000.npz")))["data_state"]
    assert (saved["completed"], saved["batch_cursor"]) == (
        (False, cursor) if cursor else (True, steps))
    resumed = trainer("crash", resume=True)
    assert (resumed.epoch, resumed.iteration) == (1, killed)
    resumed.run()
    want = [s[1:] for s in seen if s[0] == "whole"]
    got = [s[1:] for s in seen if s[0] == "crash"]
    # the killed step's batch is consumed again, nothing else
    assert got[:killed] + got[killed + 1:] == want
    for (p, a), (_, b) in zip(tree_leaves_with_path(resumed.params),
                              tree_leaves_with_path(whole.params)):
        assert torch.equal(a, b), p
