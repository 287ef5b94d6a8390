"""Async checkpoints across the two packages, on the CPU.

An ``EASGD`` run (τ 2) and a ``GOSGD`` run (default ``p_push``) of the
tiny Wide-ResNet at two workers, through each package's launcher
(``theanompi_tpu.launcher.main`` in this process on a two-device mesh;
the port's ranks in one two-rank spawn of ``rank_jobs.launch``), two
epochs of two steps with ``--checkpoint-dir``:

- the port writes the reference's layout: ``params``, ``state`` and
  ``opt_state`` as ``[2, ...]`` rows, ``center`` replicated or ``weights``
  ``(2,)``, the same leaf keys, shapes and dtypes and the same manifest
  fingerprint (its ``rule`` tag included) as the reference's;
- each package's epoch 0, resumed in the other, trains epoch 1 to the
  other's uninterrupted epoch 1: every leaf (rows, center or weights,
  optimizer state), the per-step training losses (the workers' mean,
  ``print_freq`` 1) and the validation metrics (on the center or the
  consensus) within rtol 1e-5 / atol 1e-6 (atol relative to a leaf's
  largest value at 1e-5, ``SCALE`` of ``tests/test_torch_convnets.py``);
- a resume at another worker count is refused (exit 78).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from theanompi_tpu.launcher import main as tm_main

from theanompi_torch import dist as tdist
from theanompi_torch.launcher import build_configs, build_parser
from theanompi_torch.launcher import main as port_main
from theanompi_torch.parallel.rank_jobs import run_all
from theanompi_torch.utils import checkpoint as C

RTOL, ATOL, SCALE = 1e-5, 1e-6, 1e-5
WRN = {"depth": 10, "widen": 1, "batch_size": 4, "image_size": 8,
       "n_train": 16, "n_val": 8, "precision": "fp32", "augment": False,
       "lr": 0.05}
RULES = {"EASGD": ["--rule", "EASGD", "--rule-set", "tau=2"],
         "GOSGD": ["--rule", "GOSGD"]}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _argv(rule, ck, n_epochs, pkg, extra=()):
    sets = [a for k, v in {**WRN, "n_epochs": n_epochs}.items()
            for a in ("--set", f"{k}={v!r}")]
    return ["--modelfile", f"{pkg}.models.wide_resnet", "--modelclass",
            "WideResNet", "--quiet", "--checkpoint-dir", str(ck),
            "--rule-set", "checkpoint_async=False", "--rule-set",
            "print_freq=1", *RULES[rule], *sets, *extra]


def _ref(rule, ck, n_epochs, extra=()):
    return tm_main(["--devices", "2",
                    *_argv(rule, ck, n_epochs, "theanompi_tpu", extra)])


def _port_job(rule, ck, n_epochs, extra=()):
    """The port's launcher run as ``rank_jobs.launch`` runs it on a rank."""
    args = build_parser().parse_args(
        _argv(rule, ck, n_epochs, "theanompi_torch", extra))
    model_config, rule_config = build_configs(args)
    return ("launch", ({"model_config": model_config,
                        "rule_config": rule_config, "rule": args.rule,
                        "modelfile": args.modelfile,
                        "modelclass": args.modelclass},))


def _epoch0_of(src, dst) -> str:
    """A checkpoint directory holding ``src``'s epoch 0 alone."""
    os.makedirs(dst)
    for f in ("ckpt_e0000.npz", "ckpt_e0000.manifest.json"):
        shutil.copy(os.path.join(src, f), dst)
    man = C.read_manifest(os.path.join(dst, "ckpt_e0000.npz"))
    with open(os.path.join(dst, "latest.json"), "w") as f:
        json.dump({"epoch": 0, "iteration": man["iteration"]}, f)
    return str(dst)


def _history(d, which):
    return np.load(os.path.join(d, f"{which}_history.npy"),
                   allow_pickle=True).item()


def _assert_same(got_dir, want_dir, epoch=1):
    name = f"ckpt_e{epoch:04d}.npz"
    got, want = (np.load(os.path.join(d, name)) for d in (got_dir, want_dir))
    with got, want:
        assert set(got.files) == set(want.files)
        for k in want.files:
            g, w = got[k], want[k]
            assert (g.dtype, g.shape) == (w.dtype, w.shape), k
            if k == C.DATA_STATE_LEAF or g.dtype.kind in "iu":
                np.testing.assert_array_equal(g, w, err_msg=k)
                continue
            atol = max(ATOL, SCALE * float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol,
                                       err_msg=k)
    mg, mw = (C.read_manifest(os.path.join(d, name))
              for d in (got_dir, want_dir))
    for key in ("epoch", "iteration", "lr_scale", "fingerprint",
                "data_state"):
        assert mg[key] == mw[key], key
    # the resumed run's histories hold epoch 1 alone (the copied
    # directory had none): the uninterrupted run's last entries
    for which, key in (("train", "cost"), ("val", "cost"),
                       ("val", "error")):
        g, w = (np.asarray(_history(d, which)[key], np.float64)
                for d in (got_dir, want_dir))
        assert len(g) and len(w) > len(g), (which, key)
        np.testing.assert_allclose(g, w[-len(g):], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{which} {key}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' uninterrupted runs, the port's resumes of the
    reference's epoch 0 (in the same spawn), then the reference's resumes
    of the port's."""
    d = tmp_path_factory.mktemp("async_ckpt")
    for rule in RULES:
        assert _ref(rule, d / f"ref-{rule}", 2) == 0
    calls = []
    for rule in RULES:
        calls.append(_port_job(rule, d / f"port-{rule}", 2))
        ck = _epoch0_of(d / f"ref-{rule}", d / f"ref-to-port-{rule}")
        calls.append(_port_job(rule, ck, 2, ["--resume"]))
    res = tdist.spawn(run_all, 2, "gloo", "cpu", (calls,), timeout_s=600)
    codes = [c[0] for rank in res for c in rank]
    for rule in RULES:
        ck = _epoch0_of(d / f"port-{rule}", d / f"port-to-ref-{rule}")
        codes.append(_ref(rule, ck, 2, ["--resume"]))
    return d, codes


def test_every_run_exits_0(runs):
    assert runs[1] == [0] * len(runs[1])


@pytest.mark.parametrize("rule", list(RULES))
def test_the_port_writes_the_reference_layout(runs, rule):
    d, _ = runs
    port, ref = (np.load(d / f"{p}-{rule}" / "ckpt_e0000.npz")
                 for p in ("port", "ref"))
    with port, ref:
        assert set(port.files) == set(ref.files)
        for k in ref.files:
            assert (port[k].shape, port[k].dtype) == (ref[k].shape,
                                                      ref[k].dtype), k
        stacked = [k for k in ref.files if k.split("::")[0] in
                   ("params", "state", "opt_state")]
        assert stacked and all(port[k].shape[0] == 2 for k in stacked)
        extra = "center::" if rule == "EASGD" else "weights::"
        assert any(k.startswith(extra) for k in port.files)
        if rule == "GOSGD":
            assert port["weights::"].shape == (2,)
            assert abs(float(port["weights::"].sum()) - 1) < 1e-6
    fp = [C.read_manifest(str(d / f"{p}-{rule}" / "ckpt_e0000.npz"))[
        "fingerprint"] for p in ("port", "ref")]
    assert fp[0] == fp[1]
    assert fp[0]["rule"] == rule.lower()


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("direction", ["ref-to-port", "port-to-ref"])
def test_resumed_in_the_other_package(runs, rule, direction):
    d, _ = runs
    src = "ref" if direction == "ref-to-port" else "port"
    _assert_same(d / f"{direction}-{rule}", d / f"{src}-{rule}")


def test_another_worker_count_is_refused(runs, capsys):
    d, _ = runs
    ck = _epoch0_of(d / "port-EASGD", d / "one-worker")
    assert port_main(["--device", "cpu", *_argv(
        "EASGD", ck, 2, "theanompi_torch", ["--resume"])]) == 78
    assert "fingerprint mismatch" in capsys.readouterr().err
