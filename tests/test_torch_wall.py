"""The port's two rules, as tests: no JAX at run time, and the card by
default.

- a fresh interpreter imports the port's serving and training stacks
  (the BSP rule, the launcher, the losses, the conv nets, the zoo
  (AlexNet, VGG, GoogLeNet, the LSTM, DCGAN) and their data planes, the process groups and the ranks' jobs, the native crop, the
  prefetcher, the loader pool and the token stream, the checkpoints and
  the exit codes and event log, the fault plan, the serving lifecycle
  files and the live rollout, the async rules and the rule-comparison
  and convergence harnesses, tensor parallelism and the MoE) and
  ``chip_smoke.py`` (as a module), trains a tiny ``TransformerLM`` through
  the launcher at ``--rule-set n_model=2`` (two spawned gloo ranks, the
  vocab-parallel loss), and runs the checkpoint scrubber (``--verify``)
  on an empty directory,
  without ``jax`` or ``theanompi_tpu`` ever entering ``sys.modules``
  (the spawned ranks' own modules are checked by
  ``test_torch_exchanger.py`` and ``test_torch_bsp_multirank.py``);
- a spawned process that runs the loader pool's worker on a shard
  imports neither, nor ``torch``;
- no file of ``theanompi_torch/`` (nor ``chip_smoke.py``) imports either;
- entry points called without ``device`` on a machine with no CUDA raise
  instead of running on the CPU (the launcher exits non-zero), and the
  launcher's unported flags exit 78;
- kernel modules import, and their wrappers run on CPU tensors, without
  ``nvcc``: the build happens at the first launch on the card.
"""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "theanompi_torch")
_FORBIDDEN = ("jax", "jaxlib", "theanompi_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out.extend(os.path.join(dirpath, f) for f in files
                   if f.endswith(".py"))
    return sorted(out)


def test_import_wall_in_a_fresh_interpreter():
    code = (
        "import json, sys\n"
        "import theanompi_torch.serving, theanompi_torch.serving.cli\n"
        "import theanompi_torch.convert, theanompi_torch.kernels\n"
        "import theanompi_torch.parallel.bsp, theanompi_torch.launcher\n"
        "import theanompi_torch.ops.losses\n"
        "import theanompi_torch.models.resnet50\n"
        "import theanompi_torch.models.wide_resnet\n"
        "import theanompi_torch.models.alex_net\n"
        "import theanompi_torch.models.vggnet_16\n"
        "import theanompi_torch.models.googlenet\n"
        "import theanompi_torch.models.lstm\n"
        "import theanompi_torch.models.dcgan\n"
        "import theanompi_torch.models.data.imagenet\n"
        "import theanompi_torch.models.data.cifar10\n"
        "import theanompi_torch.dist, theanompi_torch.parallel.rank_jobs\n"
        "import theanompi_torch.parallel.overlap\n"
        "import theanompi_torch.native\n"
        "import theanompi_torch.models.data.prefetch\n"
        "import theanompi_torch.models.data.shm_loader\n"
        "import theanompi_torch.models.data.stream\n"
        "import theanompi_torch.utils.checkpoint\n"
        "import theanompi_torch.resilience.codes\n"
        "import theanompi_torch.resilience.events\n"
        "import theanompi_torch.resilience.faults\n"
        "import theanompi_torch.serving.lifecycle\n"
        "import theanompi_torch.serving.rollout\n"
        "import theanompi_torch.parallel.easgd\n"
        "import theanompi_torch.parallel.gosgd\n"
        "import theanompi_torch.utils.rulecomp\n"
        "import theanompi_torch.utils.converge\n"
        "import theanompi_torch.parallel.tensor\n"
        "import theanompi_torch.ops.moe\n"
        "from theanompi_torch import EASGD, LocalSGD, GOSGD\n"
        "from theanompi_torch.launcher import main as launch\n"
        "assert launch(['--device', 'cpu', '--devices', '1', '--quiet',\n"
        "               '--rule-set', 'n_model=2', '--set', 'dim=16',\n"
        "               '--set', 'heads=2', '--set', 'n_layers=1',\n"
        "               '--set', 'seq_len=8', '--set', 'vocab=32',\n"
        "               '--set', 'n_train=8', '--set', 'n_val=4',\n"
        "               '--set', 'batch_size=4', '--set', 'n_epochs=1',\n"
        "               '--set', 'precision=\"fp32\"',\n"
        "               '--set', 'fused_loss=True']) == 0\n"
        "import tempfile\n"
        "from theanompi_torch.utils.checkpoint import main as scrub\n"
        "assert scrub(['--verify', tempfile.mkdtemp()]) == 0\n"
        "assert theanompi_torch.native.available()\n"
        "from theanompi_torch import BSP\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


_POOL_PROBE = """
import json, multiprocessing as mp, queue, sys


def child(out_q):
    from multiprocessing import shared_memory

    from theanompi_torch.models.data import shm_loader
    from theanompi_torch.models.data.imagenet import _SyntheticShards

    nbytes = 4 * 8 * 8 * 3
    shm = shared_memory.SharedMemory(create=True, size=nbytes)
    tasks, results = queue.Queue(), queue.Queue()
    tasks.put((0, _SyntheticShards(4, 3, 12, 4, 1).spec(0), 5, 0))
    tasks.put(None)
    shm_loader._worker(tasks, results, shm.name, nbytes, 8)
    _, _, shape, dtype, _ = results.get(timeout=5)
    shm.close()
    shm.unlink()
    out_q.put([list(shape), dtype, sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "theanompi_tpu", "torch"))])


if __name__ == "__main__":
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=child, args=(q,))
    p.start()
    print(json.dumps(q.get(timeout=60)))
    p.join(30)
"""


def test_spawned_pool_worker_imports_no_jax_and_no_torch(tmp_path):
    script = tmp_path / "probe.py"
    script.write_text(_POOL_PROBE)
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run([sys.executable, str(script)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    shape, dtype, bad = json.loads(r.stdout.strip().splitlines()[-1])
    assert (shape, dtype) == ([4, 8, 8, 3], "uint8")
    assert bad == []


def test_static_scan_finds_no_forbidden_import():
    line_re = re.compile(r"^\s*(import|from)\s+(jax|theanompi_tpu)")
    for path in _port_files():
        with open(path) as f:
            src = f.read()
        for n, line in enumerate(src.splitlines(), 1):
            assert not line_re.match(line), f"{path}:{n}: {line}"
        for node in ast.walk(ast.parse(src)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in _FORBIDDEN, \
                    f"{path}:{node.lineno} imports {name}"


def test_entry_points_without_device_raise_when_no_cuda(monkeypatch):
    from theanompi_torch.models.transformer_lm import TransformerLM
    from theanompi_torch.parallel.mesh import resolve_device
    from theanompi_torch.serving import InferenceEngine, PagedKVCache
    from theanompi_torch.serving.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    model = TransformerLM({"dim": 16, "heads": 2, "n_layers": 1,
                           "seq_len": 16, "vocab": 12,
                           "precision": "fp32"})
    params, _ = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA"):
        InferenceEngine(model, params, block_size=4, max_batch=1)
    with pytest.raises(RuntimeError, match="no CUDA"):
        PagedKVCache.create(n_layers=1, num_blocks=2, block_size=4, heads=2,
                            head_dim=8, max_batch=1, max_context=8)
    # the CLI reports it as a serving failure (exit 70), never serves
    assert main(["--set", "dim=16", "--set", "heads=2", "--set",
                 "n_layers=1", "--set", "seq_len=16", "--set",
                 "vocab=12"]) == 70
    # training: the BSP rule and the launcher refuse too, never train
    from theanompi_torch import BSP
    from theanompi_torch.launcher import main as launch

    tiny = {"dim": 16, "heads": 2, "n_layers": 1, "seq_len": 16,
            "vocab": 12, "n_train": 4, "n_val": 2, "batch_size": 2}
    with pytest.raises(RuntimeError, match="no CUDA"):
        BSP().init(devices=1, model_config=tiny)
    argv = [a for k, v in tiny.items() for a in ("--set", f"{k}={v}")]
    assert launch(argv) == 70


@pytest.mark.parametrize("flags", [
    ["--resume-reshard"], ["--telemetry-dir", "tel"], ["--elastic"],
    ["--supervise"], ["--compile-cache-dir", "x"], ["--max-restarts", "2"],
    ["--hang-timeout", "5"], ["--sentinel", "abort"]])
def test_launcher_unported_flags_exit_78(flags, capsys):
    from theanompi_torch.launcher import main as launch

    assert launch(["--device", "cpu", *flags]) == 78
    err = capsys.readouterr().err
    assert err.startswith("tmlauncher: error: config:")
    assert "not yet ported" in err


def test_launcher_trains_on_cpu_when_asked(capsys):
    from theanompi_torch.launcher import main as launch

    argv = ["--device", "cpu", "--rule-set", "print_freq=2"]
    for k, v in {"dim": 16, "heads": 2, "n_layers": 1, "seq_len": 16,
                 "vocab": 32, "n_train": 8, "n_val": 4, "batch_size": 4,
                 "n_epochs": 1, "precision": "fp32"}.items():
        argv += ["--set", f"{k}={v!r}"]
    assert launch(argv) == 0
    out = capsys.readouterr().out
    assert "iter 2:" in out and "tmlauncher: done. final val:" in out
    # an unknown rule key of the reference's is refused, a config error
    assert launch(argv + ["--rule-set", "telemetry_dir='x'"]) == 78


def test_kernel_modules_build_lazily():
    import theanompi_torch.kernels as K
    from theanompi_torch.ops.flash_attention import (
        FLASH_BWD_DKV,
        FLASH_BWD_DQ,
        FLASH_FWD,
    )
    from theanompi_torch.ops.paged_attention import PAGED_DECODE
    from theanompi_torch.ops.quant import INT8_MATMUL
    from theanompi_torch.ops import quant
    from theanompi_torch.serving.quant import quantize_tree

    assert {k.name for k in K.KERNELS} == {
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_decode",
        "int8_matmul"}
    for k in (FLASH_FWD, FLASH_BWD_DQ, FLASH_BWD_DKV, PAGED_DECODE,
              INT8_MATMUL):
        assert os.path.exists(os.path.join(K.CSRC, k.source))
    before = {k.name: k.launches for k in K.KERNELS}
    # CPU tensors take the plain versions: nothing builds, nothing counts
    w = {"w": torch.randn(8, 16, generator=torch.Generator().manual_seed(0))}
    qt = quantize_tree(w, torch.Generator().manual_seed(1), 32)[0]["w"]
    x = torch.ones(2, 8)
    quant.int8_matmul(x, qt)
    assert {k.name: k.launches for k in K.KERNELS} == before
    assert all(k._lib is None for k in K.KERNELS)
    if not any(os.path.exists(os.path.join(d, "nvcc")) for d in
               os.environ.get("PATH", "").split(os.pathsep) + [
                   "/usr/local/cuda/bin"]):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            K._nvcc()
    assert np.isfinite(quant.int8_matmul_ref(x, qt).numpy()).all()
