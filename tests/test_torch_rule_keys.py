"""The rule keys of unported features: their off values train, their on
values are refused.

The reference resolves these keys to "off" (``ResilienceConfig``,
``theanompi_tpu/resilience/__init__.py:83-102``, and its trainer's
``resume_reshard``, ``telemetry_dir``, ``profile_dir``): ``watchdog``
False, or None with no heartbeat; ``handle_preemption`` False, or None
outside a supervisor; ``fault_plan``, ``sentinel_policy``,
``telemetry_dir`` and ``profile_dir`` None; ``resume_reshard`` False;
and each feature's tuning keys while it is off.  Its
``tests/test_resilience.py:413`` builds ``BSP(config={"verbose": False,
"watchdog": False})``.  The port accepts exactly those values (the tiny
WRN trains a step under each) and refuses every value that turns a
feature on (``NotImplementedError``; the launcher's exit 78).
"""

import pytest
import torch

from theanompi_torch import BSP
from theanompi_torch.launcher import main as launch
from theanompi_torch.parallel.trainer import NOT_PORTED_KEYS

WRN = {"depth": 10, "widen": 1, "batch_size": 4, "image_size": 8,
       "n_train": 8, "n_val": 4, "n_epochs": 1, "precision": "fp32",
       "augment": False, "lr": 0.05}
OFF = [{"watchdog": False},
       {"watchdog": None, "watchdog_multiple": 4.0, "watchdog_min_s": 1.0,
        "watchdog_poll_s": 0.5},
       {"handle_preemption": False},
       {"handle_preemption": None},
       {"fault_plan": None, "sentinel_policy": None,
        "sentinel_max_skips": 3, "sentinel_max_rollbacks": 1},
       {"telemetry_dir": None, "telemetry_max_bytes": 1 << 20,
        "telemetry_keep": 2, "telemetry_health": True,
        "telemetry_blackbox": 64, "telemetry_profile": True},
       {"profile_dir": None, "profile_window": (2, 4)},
       {"resume_reshard": False}]
ON = [{"watchdog": True}, {"heartbeat_path": "hb"},
      {"handle_preemption": True}, {"sentinel_policy": "abort"},
      {"resume_reshard": True}]


@pytest.fixture(autouse=True)
def _unsupervised(monkeypatch):
    for var in ("THEANOMPI_HEARTBEAT", "THEANOMPI_SUPERVISED"):
        monkeypatch.delenv(var, raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("off", OFF, ids=lambda c: ",".join(c))
def test_off_values_train(off):
    assert set(off) <= set(NOT_PORTED_KEYS)
    rule = BSP(config={"verbose": False, **off}).init(
        devices=1, modelfile="theanompi_torch.models.wide_resnet",
        modelclass="WideResNet", model_config=dict(WRN), device="cpu")
    tr = rule.trainer
    batch = next(iter(tr.model.data.train_batches(tr.global_batch, 0)))
    assert torch.isfinite(torch.as_tensor(tr.train_iter(batch, 0.05)["cost"]))


@pytest.mark.parametrize("on", ON, ids=lambda c: ",".join(c))
def test_on_values_are_refused(on):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        BSP(config={"verbose": False, **on}).init(
            devices=1, modelfile="theanompi_torch.models.wide_resnet",
            modelclass="WideResNet", model_config=dict(WRN), device="cpu")


def test_the_environment_turns_the_auto_values_on(monkeypatch):
    """None is the reference's "auto": on under a heartbeat or a
    supervisor, which the port does not carry."""
    monkeypatch.setenv("THEANOMPI_HEARTBEAT", "/nonexistent/hb")
    with pytest.raises(NotImplementedError, match="watchdog"):
        BSP(config={"watchdog": None}).init(
            devices=1, modelfile="theanompi_torch.models.wide_resnet",
            modelclass="WideResNet", model_config=dict(WRN), device="cpu")


def test_launcher_takes_an_off_value_and_refuses_an_on_one(capsys):
    argv = ["--device", "cpu", "--modelfile",
            "theanompi_torch.models.wide_resnet", "--modelclass",
            "WideResNet", "--quiet"]
    for k, v in WRN.items():
        argv += ["--set", f"{k}={v!r}"]
    assert launch([*argv, "--rule-set", "watchdog=False"]) == 0
    assert launch([*argv, "--rule-set", "watchdog=True"]) == 78
    assert "not yet ported" in capsys.readouterr().err
