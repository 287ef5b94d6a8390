"""The port's convergence harness (``theanompi_torch.utils.converge``) at
toy sizes, in one process on the CPU.

``converge_all`` with its rows cut to toy size (a classifier row under
BSP and one under EASGD, one LM row with one seed, DCGAN and WGAN one
seed and one epoch at 8 px): the artifact's keys at the top level and in
each kind of row (classifier, LM with its per-seed summaries, each GAN
with its per-seed summaries) equal those of the reference's committed
``CONVERGE.json``; the verdicts follow the rows' own gates (a target the
classifiers reach at their first validation; the LM's perplexity curve
against its target); the artifact is on disk; and the CLI's flags reach
the rows (its ranks run in this process here).
"""

import json
import os

import numpy as np
import pytest
import torch

from theanompi_torch import dist as tdist
from theanompi_torch.utils import converge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = {"depth": 10, "widen": 1, "batch_size": 8, "image_size": 8,
        "n_train": 16, "n_val": 16, "precision": "fp32", "lr": 0.05}
CLASSIFIERS = [
    ("wrn_toy", "theanompi_torch.models.wide_resnet", "WideResNet", FAST,
     2.0, 1),
    ("wrn_toy_easgd", "theanompi_torch.models.wide_resnet", "WideResNet",
     FAST, 2.0, 1, "EASGD", {"tau": 1, "scale_lr": False}),
]
SEQUENCES = [
    ("lstm_toy", "theanompi_torch.models.lstm", "LSTM",
     {"batch_size": 4, "n_train": 16, "n_val": 8, "seq_len": 8, "vocab": 16,
      "hidden": 8, "embed_dim": 8, "n_layers": 1, "dropout": 0.0,
      "lr": 1.0, "momentum": 0.9, "lr_decay_epochs": (), "grad_clip": 5.0,
      "precision": "fp32"}, 100.0, 2),
]
GAN = {"batch_size": 4, "image_size": 8, "gen_base": 8, "disc_base": 8,
       "z_dim": 4, "n_train": 8, "n_val": 64, "precision": "fp32",
       "verbose": False}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _toy_rows(mp):
    mp.setattr(converge, "CLASSIFIER_RUNS", CLASSIFIERS)
    mp.setattr(converge, "SEQUENCE_RUNS", SEQUENCES)
    mp.setattr(converge, "DCGAN_CONFIG", {**GAN, "disc_lr_scale": 0.25})
    mp.setattr(converge, "WGAN_CONFIG", dict(GAN))
    for name in ("converge_dcgan", "converge_wgan",
                 "converge_sequence_models"):
        fn = getattr(converge, name)
        mp.setattr(converge, name,
                   lambda *a, _fn=fn, **k: _fn(*a, **{**k, "seeds": (0,)}))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    out = tmp_path_factory.mktemp("converge") / "CONVERGE_cuda.json"
    with pytest.MonkeyPatch.context() as mp:
        _toy_rows(mp)
        art = converge.converge_all(devices=1, dcgan_epochs=1,
                                    wgan_epochs=1, device="cpu",
                                    out_path=str(out))
    return art, out


@pytest.fixture(scope="module")
def reference():
    with open(os.path.join(REPO, "CONVERGE.json")) as f:
        ref = json.load(f)
    return ref, {r["model"]: r for r in ref["results"]}


def _keys(row):
    return set(row)


def test_top_level_keys_and_file(artifact, reference):
    art, out = artifact
    assert set(art) == set(reference[0])
    assert json.loads(out.read_text()) == json.loads(json.dumps(art))
    assert [r["model"] for r in art["results"]] == [
        "wrn_toy", "wrn_toy_easgd", "lstm_toy", "dcgan_matched",
        "wgan_matched"]
    assert art["passed"] == all(r["passed"] for r in art["results"])


def test_classifier_rows(artifact, reference):
    rows = artifact[0]["results"][:2]
    want = _keys(reference[1]["resnet50_easgd_tau4"])
    for row in rows:
        assert _keys(row) == want
        assert row["passed"] and row["epochs_to_target"] == 0
        assert np.isfinite(row["best_val_error"])
    assert (rows[0]["rule"], rows[1]["rule"]) == ("BSP", "EASGD")
    assert rows[1]["rule_config"] == {"tau": 1, "scale_lr": False}


def test_sequence_row(artifact, reference):
    row = artifact[0]["results"][2]
    ref = reference[1]["lstm_ptb_synth"]
    assert _keys(row) == _keys(ref)
    assert [set(s) for s in row["seeds"]] == [set(ref["seeds"][0])]
    curve = row["val_perplexity_curve"]
    assert row["passed"] == any(v <= row["target_perplexity"] for v in curve)
    assert row["entropy_floor_perplexity"] > 1


@pytest.mark.parametrize("i,name", [(3, "dcgan_matched"),
                                    (4, "wgan_matched")])
def test_gan_rows(artifact, reference, i, name):
    row = artifact[0]["results"][i]
    ref = reference[1][name]
    assert row["model"] == name
    assert _keys(row) == _keys(ref)
    assert [set(s) for s in row["seeds"]] == [set(ref["seeds"][0])]
    # (one epoch of a toy GAN: its eval-mode samples barely vary yet, so
    # only the statistics' being measured is held here)
    assert all(np.isfinite(row[k]) for k in ("std_ratio", "swd_fake_real",
                                             "swd_real_real"))
    assert row["swd_real_real"] > 0


def test_cli_reaches_the_rows(tmp_path, monkeypatch, capsys):
    _toy_rows(monkeypatch)
    monkeypatch.setattr(tdist, "spawn", lambda fn, n, backend, device,
                        args, **kw: [fn(device, *args)])
    out = tmp_path / "C.json"
    assert converge.main(["--devices", "1", "--device", "cpu",
                          "--dcgan-epochs", "1", "--wgan-epochs", "1",
                          "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["devices"] == 1
    assert {r["model"]: r.get("epochs") for r in art["results"][3:]} == {
        "dcgan_matched": 1, "wgan_matched": 1}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == {"passed": art["passed"], "out": str(out)}
