"""The port's rule comparison (``theanompi_torch.utils.rulecomp``) on two
gloo CPU ranks, in one spawn.

The counterpart of ``tests/test_rulecomp.py``: ``compare_rules`` on a toy
grid (BSP, EASGD τ 2 with an α override list crossed with an LR sweep,
LocalSGD τ 2, GOSGD) at a target every rule reaches at its first
validation, and GOSGD at one it never reaches: the early stop, the
accounting, the sweep and the artifact on disk, whose keys (top level,
rows, sweep entries) are those of the reference's committed artifact
``RULECOMP_r05.json``; EASGD's rows train at twice the base LR (its
``scale_lr`` hook at two workers), LocalSGD's at the base.  And
``warmup`` (every path once, then a fresh init) leaves EASGD's and
GOSGD's trees bit-equal to a fresh init, the counters at 0, on both
ranks.
"""

import json
import os

import numpy as np
import pytest
import torch

from theanompi_torch import dist as tdist
from theanompi_torch.parallel.rank_jobs import run_all
from theanompi_torch.utils import rulecomp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = {"depth": 10, "widen": 1, "batch_size": 8, "image_size": 8,
        "n_train": 64, "n_val": 32, "precision": "fp32", "lr": 0.05}
GRID = [("bsp", "BSP", {}),
        ("easgd_tau2", "EASGD", {"tau": 2},
         [{"alpha": 0.05}, {"alpha": 0.3}]),
        ("localsgd_tau2", "LocalSGD", {"tau": 2}),
        ("gosgd", "GOSGD", {})]
SWEEP = (0.01, 0.05)
WARM = {"modelfile": "theanompi_torch.models.wide_resnet",
        "modelclass": "WideResNet", "model_config": dict(FAST)}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("rulecomp")
    base = {"devices": 2, "model_config": dict(FAST), "verbose": False}
    calls = [
        ("compare_rules", ({**base, "target_error": 2.0, "max_epochs": 2,
                            "rules": GRID, "lr_sweep": SWEEP,
                            "out_path": str(d / "rc.json")},)),
        ("compare_rules", ({**base, "target_error": 0.0, "max_epochs": 2,
                            "rules": [("gosgd", "GOSGD", {})]},)),
        ("warmup_case", ({**WARM, "rule": "EASGD",
                          "rule_config": {"tau": 4}},)),
        ("warmup_case", ({**WARM, "rule": "GOSGD",
                          "rule_config": {"p_push": 1.0}},)),
    ]
    return d, tdist.spawn(run_all, 2, "gloo", "cpu", (calls,),
                          timeout_s=600)


def _reference_keys():
    with open(os.path.join(REPO, "RULECOMP_r05.json")) as f:
        ref = json.load(f)
    rows = ref["results"]
    return (set(ref) - {"diagnosis"},
            {"overrides": set(next(r for r in rows
                                   if "rule_overrides" in r)),
             "plain": set(next(r for r in rows
                               if "rule_overrides" not in r))},
            {frozenset(s) for r in rows for s in r["sweep"]})


def test_compare_rules_artifact(ranks):
    d, res = ranks
    art = res[0][0]
    assert json.loads((d / "rc.json").read_text()) == art
    assert [r["rule"] for r in art["results"]] == [g[0] for g in GRID]
    assert art["devices"] == 2 and art["lr_sweep"] == list(SWEEP)
    assert art["model"] == "theanompi_torch.models.wide_resnet.WideResNet"
    for row in art["results"]:
        # target 2.0 is reached at the first validation: an early stop
        assert row["reached"] and row["epochs_to_target"] == 0
        assert row["epochs_run"] == 1 and row["steps_run"] > 0
        assert row["steps_to_target"] == row["steps_run"]
        assert row["wall_s"] > 0
        assert len(row["val_error_curve"]) == row["epochs_run"]
        assert np.isfinite(row["best_val_error"])
        scale = 2 if row["rule_class"] == "EASGD" else 1
        assert all(s["effective_lr"] == pytest.approx(scale * s["base_lr"])
                   for s in row["sweep"])
    easgd = art["results"][1]
    assert len(easgd["sweep"]) == 4  # 2 LRs x 2 alphas
    assert {(s["base_lr"], s["rule_overrides"]["alpha"])
            for s in easgd["sweep"]} == {(a, b) for a in SWEEP
                                         for b in (0.05, 0.3)}
    # rank 1 ran the same grid
    assert [r["rule"] for r in res[1][0]["results"]] == [g[0] for g in GRID]


def test_artifact_keys_equal_the_reference(ranks):
    top, rows, sweeps = _reference_keys()
    art = ranks[1][0][0]
    assert set(art) == top
    for row in art["results"]:
        assert set(row) == rows["overrides" if "rule_overrides" in row
                                else "plain"]
        assert {frozenset(s) for s in row["sweep"]} <= sweeps


def test_compare_rules_runs_to_max_epochs(ranks):
    (row,) = ranks[1][0][1]["results"]
    assert not row["reached"] and row["epochs_to_target"] is None
    assert row["epochs_run"] == 2


@pytest.mark.parametrize("case", [2, 3])
def test_warmup_runs_then_resets(ranks, case):
    for r in range(2):
        out = ranks[1][r][case]
        assert out["stepped"] != out["fresh"]  # a step moved the trees
        assert out["warm"] == out["fresh"]
        assert (out["iteration"], out["epoch"]) == (0, 0)
        assert out["comm_segments"] == 0  # a fresh recorder


def test_default_rulesets_cover_the_reference_grid():
    names = [n for n, _, _ in rulecomp.default_rulesets()]
    assert names == ["bsp", "easgd_tau1", "easgd_tau4", "easgd_tau16",
                     "gosgd"]


def test_cli_writes_the_artifact(tmp_path, monkeypatch, capsys):
    """``main``'s flags reach the ranks' grid (the ranks run in this
    process here: the spawn itself is the fixture's)."""
    monkeypatch.setattr(rulecomp, "DEFAULT_MODEL_CONFIG",
                        {**FAST, "n_train": 16, "n_val": 16})
    monkeypatch.setattr(rulecomp, "default_rulesets",
                        lambda: [("easgd_tau1", "EASGD", {"tau": 1})])
    monkeypatch.setattr(tdist, "spawn", lambda fn, n, backend, device,
                        args, **kw: [fn(device, *args)])
    out = tmp_path / "rc.json"
    assert rulecomp.main(["--devices", "1", "--device", "cpu",
                          "--target-error", "2.0", "--max-epochs", "1",
                          "--lr-sweep", "0.01,0.02", "--out",
                          str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["lr_sweep"] == [0.01, 0.02] and art["target_error"] == 2.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == {"reached": 1, "of": 1, "out": str(out)}
