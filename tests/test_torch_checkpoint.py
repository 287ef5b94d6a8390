"""The port's checkpoints (``theanompi_torch.utils.checkpoint``) on the
CPU, after the reference's library tests.

- ``tests/test_checkpoint_launcher.py:18,37``: a round trip with
  retention, and a shape that differs from the template's;
- ``tests/test_checkpoint_async.py:54,115,132,144,175``: an async and a
  sync save of one train state publish the same leaves and the same
  manifest bytes; a writer's error surfaces at the next save and at the
  join; a crash between serialization and publish (the
  ``_pre_publish_hook`` seam) resumes the previous epoch, its debris
  swept; ``.tmp`` debris takes no retention slot;
- the save returns before the write (the writer held by an event, not a
  sleep), and the snapshot owns its bytes: a tensor changed in place
  after ``save`` returns does not reach the file;
- ``fast`` and ``full`` verification against a truncated archive, a
  missing manifest and a bit flipped inside a leaf (``fast`` reads only
  the zip's directory, so only ``full`` sees the flip);
- the recovery chain: two corrupt newest files quarantined, the chain
  steps back and records ``ckpt.fallback``; then none left,
  ``CheckpointChainExhausted``;
- the ``dirty`` marker turning ``checkpoint_verify="auto"`` into
  ``full``; a fingerprint refusal, and ``resume_force`` making it a
  warning; the scrubber CLI's exits 0 and 77;
- the trainer's resume round trip under ``psum`` and ``zero1`` (one
  process).

Every save whose order matters is synchronous or gated by an event.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from theanompi_torch import BSP
from theanompi_torch.tree import tree_leaves_with_path
from theanompi_torch.utils import checkpoint as C

from chip_smoke import flip_leaf_byte

#: the reference's tiny Wide-ResNet of ``test_checkpoint_async.py``
TINY = {"depth": 10, "widen": 1, "batch_size": 8, "image_size": 8,
        "n_train": 32, "n_val": 16, "n_epochs": 1, "precision": "fp32",
        "augment": False, "verbose": False, "lr": 0.05}
TREE = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
        "b": {"c": np.ones((4,), np.int32)}}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _trainer(ck_dir=None, strategy="psum", n_epochs=1, **rule):
    return BSP({"exch_strategy": strategy, "verbose": False,
                "checkpoint_dir": ck_dir, **rule}).init(
        devices=1, modelfile="theanompi_torch.models.wide_resnet",
        modelclass="WideResNet", model_config={**TINY,
                                               "n_epochs": n_epochs},
        device="cpu").trainer


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _leaves(tree):
    return {"/".join(map(str, p)): x for p, x in tree_leaves_with_path(tree)}


def test_checkpointer_roundtrip(tmp_path):
    ck = C.Checkpointer(str(tmp_path), keep=2)
    for e in range(3):
        ck.save(e, 10 * (e + 1), {"params": TREE})
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert files == ["ckpt_e0001.npz", "ckpt_e0002.npz"]
    assert ck.latest_epoch() == 2 and ck.latest_iteration() == 30
    template = {"a": np.zeros((2, 3), np.float32),
                "b": {"c": np.zeros((4,), np.int32)}}
    out = ck.load(2, {"params": template})["params"]
    np.testing.assert_array_equal(out["a"], TREE["a"])
    np.testing.assert_array_equal(out["b"]["c"], TREE["b"]["c"])
    # tensors as templates: their dtype and device
    out = ck.load(2, {"params": {"a": torch.zeros(2, 3),
                                 "b": {"c": torch.zeros(4, dtype=torch.int32)}
                                 }})["params"]
    assert out["b"]["c"].dtype == torch.int32
    assert torch.equal(out["a"], torch.from_numpy(TREE["a"]))


def test_checkpointer_shape_mismatch(tmp_path):
    ck = C.Checkpointer(str(tmp_path))
    ck.save(0, 1, {"params": {"a": np.zeros((2,), np.float32)}})
    with pytest.raises(ValueError, match="shape"):
        ck.load(0, {"params": {"a": np.zeros((3,), np.float32)}})
    with pytest.raises(KeyError, match="missing leaf"):
        ck.load(0, {"params": {"b": np.zeros((2,), np.float32)}})


def test_async_and_sync_publish_bit_identical(tmp_path):
    tr = _trainer()
    batch = next(iter(tr.model.data.train_batches(tr.global_batch, 0,
                                                  seed=0)))
    tr.train_iter(batch, 0.05)
    paths = []
    for mode in (False, True):
        ck = C.Checkpointer(str(tmp_path / str(mode)), async_save=mode,
                            encode=tr._encode,
                            fingerprint=tr._run_fingerprint)
        ck.save(0, 4, tr.checkpoint_trees(),
                data_state=tr._data_state(0, True)).join()
        paths.append(ck._path(0))
    a, b = (_npz(p) for p in paths)
    assert sorted(a) == sorted(b) and "__data_state__" in a
    assert any(k.startswith("opt_state::velocity/") for k in a)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    ma, mb = (open(C._manifest_path(p), "rb").read() for p in paths)
    assert ma == mb


def test_save_returns_before_the_write_and_owns_its_bytes(tmp_path):
    ck = C.Checkpointer(str(tmp_path), async_save=True)
    gate = threading.Event()
    ck._pre_publish_hook = lambda epoch: gate.wait(30)
    w = torch.arange(6, dtype=torch.float32)
    handle = ck.save(0, 1, {"params": {"w": w}})
    assert not handle.done() and not os.path.exists(handle.path)
    w.add_(100.0)  # the next step may change what was saved
    gate.set()
    handle.join()
    np.testing.assert_array_equal(_npz(handle.path)["params::w"],
                                  np.arange(6, dtype=np.float32))


def test_snapshot_takes_handed_over_host_leaves_as_they_are(tmp_path):
    # zero1's gathered buckets are the save's own: no clone of them
    ck = C.Checkpointer(str(tmp_path))
    w, bucket = torch.ones(4), torch.zeros(8)
    snap = ck._stager.snapshot({"params": {"w": w},
                                "opt_state": {"velocity": [bucket]}},
                               handed_over=[bucket])
    assert snap.wait()["opt_state"]["velocity"][0] is bucket
    assert snap.trees["params"]["w"] is not w
    ck.save(0, 1, {"opt_state": {"velocity": [bucket]}},
            handed_over=[bucket])
    np.testing.assert_array_equal(
        _npz(ck._path(0))["opt_state::velocity/0"], np.zeros(8, np.float32))


def test_writer_exception_surfaces_at_next_save(tmp_path):
    ck = C.Checkpointer(str(tmp_path), async_save=True)

    def boom(epoch):
        raise ValueError("disk full")

    ck._pre_publish_hook = boom
    ck.save(0, 1, {"params": TREE})
    with pytest.raises(ValueError, match="disk full"):
        ck.save(1, 2, {"params": TREE})
    # delivered once; the engine keeps working
    ck._pre_publish_hook = None
    ck.save(2, 3, {"params": TREE}).join()
    assert ck.latest_epoch() == 2


def test_writer_exception_surfaces_at_join(tmp_path):
    ck = C.Checkpointer(str(tmp_path), async_save=True)

    def boom(epoch):
        raise RuntimeError("torn write")

    ck._pre_publish_hook = boom
    handle = ck.save(0, 1, {"params": TREE})
    with pytest.raises(RuntimeError, match="torn write"):
        handle.join()


def test_crash_mid_write_resumes_previous_epoch(tmp_path):
    ck_dir = str(tmp_path / "ck")
    tr = _trainer(ck_dir, n_epochs=2)
    tr.run()  # publishes epochs 0 and 1
    params_e1 = {k: x.clone() for k, x in _leaves(tr.params).items()}

    def crash(epoch):
        raise RuntimeError("simulated kill before publish")

    tr.checkpointer._pre_publish_hook = crash
    tr.iteration += 1
    handle = tr.save_checkpoint(2)
    with pytest.raises(RuntimeError, match="simulated kill"):
        handle.join()
    assert [f for f in os.listdir(ck_dir) if f.endswith(".tmp.npz")] == [
        "ckpt_e0002.npz.tmp.npz"]
    # a restarted run sweeps the debris and resumes the last published
    t2 = _trainer(ck_dir, n_epochs=2)
    assert not any(f.endswith(".tmp.npz") for f in os.listdir(ck_dir))
    assert t2.try_resume() and t2.epoch == 2
    for k, x in _leaves(t2.params).items():
        assert torch.equal(x, params_e1[k]), k


def test_prune_ignores_tmp_debris(tmp_path):
    ck = C.Checkpointer(str(tmp_path), keep=2)
    for e in range(3):
        ck.save(e, e, {"params": TREE})
    debris = tmp_path / "ckpt_e0003.npz.tmp.npz"
    debris.touch()
    ck.save(4, 4, {"params": TREE})
    real = sorted(f for f in os.listdir(tmp_path) if C._is_ckpt(f))
    assert real == ["ckpt_e0002.npz", "ckpt_e0004.npz"]
    assert sorted(f for f in os.listdir(tmp_path)
                  if f.endswith(".manifest.json")) == [
        "ckpt_e0002.manifest.json", "ckpt_e0004.manifest.json"]
    assert debris.exists()  # the prune never deletes it; a start sweeps
    ck2 = C.Checkpointer(str(tmp_path), keep=2)
    assert not debris.exists() and ck2.latest_epoch() == 4


def _damage(path, how):
    if how == "truncate":
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
    elif how == "manifest":
        os.remove(C._manifest_path(path))
    else:
        flip_leaf_byte(path, "params::a.npy")


@pytest.mark.parametrize("level", ["fast", "full"])
@pytest.mark.parametrize("how", ["truncate", "manifest", "bitflip"])
def test_verify_levels(tmp_path, level, how):
    ck = C.Checkpointer(str(tmp_path))
    ck.save(0, 1, {"params": {"a": np.arange(64, dtype=np.float32)}})
    path = ck._path(0)
    assert C.verify_file(path, level)["epoch"] == 0
    _damage(path, how)
    if level == "fast" and how == "bitflip":
        # the archive's directory is intact: only the full read sees it
        C.verify_file(path, "fast")
        return
    with pytest.raises(C.CheckpointCorruptError):
        C.verify_file(path, level)


def test_recovery_chain_steps_back_then_is_exhausted(tmp_path, capsys):
    from theanompi_torch.resilience.events import read_events

    ck = C.Checkpointer(str(tmp_path), keep=5)
    for e in range(4):
        ck.save(e, 10 * e, {"params": {"a": np.full(8, e, np.float32)}})
    _damage(ck._path(3), "truncate")
    flip_leaf_byte(ck._path(2))
    template = {"params": {"a": np.zeros(8, np.float32)}}
    ep, it, out = ck.load_latest_verified(template, verify="full")
    assert (ep, it) == (1, 10)
    np.testing.assert_array_equal(out["params"]["a"], np.ones(8))
    assert sorted(os.listdir(tmp_path / "corrupt")) == [
        "ckpt_e0002.manifest.json", "ckpt_e0002.npz",
        "ckpt_e0003.manifest.json", "ckpt_e0003.npz"]
    events = read_events(str(tmp_path / "resilience.json"))
    assert [e["name"] for e in events] == [
        "ckpt.quarantine", "ckpt.quarantine", "ckpt.fallback"]
    assert events[-1]["bad_epochs"] == [3, 2]
    assert events[-1]["restored_epoch"] == 1
    with open(tmp_path / "latest.json") as f:
        assert json.load(f)["epoch"] == 1
    for e in (0, 1):
        flip_leaf_byte(ck._path(e))
    with pytest.raises(C.CheckpointChainExhausted, match="quarantined"):
        ck.load_latest_verified(template, verify="full")
    assert "stepping back" in capsys.readouterr().err
    # an empty directory is a fresh start, not an error
    assert C.Checkpointer(str(tmp_path / "empty")).load_latest_verified(
        template) is None


def test_dirty_marker_turns_auto_into_full(tmp_path):
    tr = _trainer(str(tmp_path / "ck"))
    assert tr._resume_verify_level() == "fast"
    tr.save_checkpoint(0).join()
    assert tr.checkpointer.was_unclean()
    assert tr._resume_verify_level() == "full"
    tr.checkpointer.mark_clean()
    assert not tr.checkpointer.was_unclean()
    assert tr._resume_verify_level() == "fast"
    tr.checkpoint_verify = "none"
    assert tr._resume_verify_level() == "none"
    with pytest.raises(ValueError, match="checkpoint_verify"):
        _trainer(str(tmp_path / "ck2"), checkpoint_verify="sometimes")


def test_fingerprint_refusal_and_resume_force(tmp_path, capsys):
    ck = C.Checkpointer(str(tmp_path), fingerprint={"mesh": {"data": 1}})
    ck.save(0, 1, {"params": TREE})
    template = {"params": {"a": np.zeros((2, 3), np.float32),
                           "b": {"c": np.zeros((4,), np.int32)}}}
    other = C.Checkpointer(str(tmp_path),
                           fingerprint=lambda: {"mesh": {"data": 2}})
    with pytest.raises(C.CheckpointFingerprintError, match="mesh"):
        other.load_latest_verified(template)
    # a refusal quarantines nothing: the file belongs to another run
    assert C._is_ckpt("ckpt_e0000.npz") and os.path.exists(ck._path(0))
    forced = C.Checkpointer(str(tmp_path), resume_force=True,
                            fingerprint={"mesh": {"data": 2}})
    ep, _, out = forced.load_latest_verified(template)
    assert ep == 0
    np.testing.assert_array_equal(out["params"]["a"], TREE["a"])
    assert "WARNING" in capsys.readouterr().err


def test_scrubber_cli_exits_0_and_77(tmp_path, capsys):
    from theanompi_torch.resilience.codes import EXIT_CKPT

    ck = C.Checkpointer(str(tmp_path))
    for e in range(2):
        ck.save(e, e, {"params": TREE})
    assert C.main(["--verify", str(tmp_path)]) == 0
    assert "2/2 checkpoints verifiable (full)" in capsys.readouterr().out
    flip_leaf_byte(ck._path(1))
    assert C.main(["--verify", str(tmp_path), "--fast"]) == 0
    assert C.main(["--verify", str(tmp_path)]) == EXIT_CKPT == 77
    assert "CORRUPT" in capsys.readouterr().out
    assert C.main(["--verify", str(tmp_path), "--quarantine"]) == 77
    assert os.path.exists(tmp_path / "corrupt" / "ckpt_e0001.npz")
    assert C.main(["--verify", str(tmp_path)]) == 0


@pytest.mark.parametrize("strategy", ["psum", "zero1"])
def test_trainer_resume_round_trip(tmp_path, strategy):
    ck = str(tmp_path / "ck")
    tr = _trainer(ck, strategy=strategy)
    tr.run()
    t2 = _trainer(ck, strategy=strategy)
    assert t2.try_resume()
    assert (t2.epoch, t2.iteration) == (1, tr.iteration)
    for name in ("params", "state", "opt_state"):
        mine, want = (_leaves(getattr(t, name)) for t in (t2, tr))
        assert mine.keys() == want.keys() and mine, name
        for k in want:
            assert torch.equal(mine[k], want[k]), (name, k)
    with np.load(os.path.join(ck, "ckpt_e0000.npz")) as z:
        # conv kernels HWIO in the file, as the reference keeps them
        k4 = [k for k in z.files if z[k].ndim == 4]
        assert k4 and all(z[k].shape[:2] in ((1, 1), (3, 3)) for k in k4)
