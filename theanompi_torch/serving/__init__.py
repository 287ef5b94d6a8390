"""Serving path of the port: continuous-batching inference for
``TransformerLM`` on the card.

- :mod:`~theanompi_torch.serving.kv_cache` — paged KV cache (in-place
  writes, reserved null block) and the refcounted block pool;
- :mod:`~theanompi_torch.serving.engine` — prefill/decode steps, sampling,
  int8 weights, the live weight swap;
- :mod:`~theanompi_torch.serving.scheduler` — admission, join/evict,
  longest-first preemption, typed terminal states, the open-loop and the
  durable-queue drive loops;
- :mod:`~theanompi_torch.serving.prefix_cache` — radix prefix cache;
- :mod:`~theanompi_torch.serving.quant` — int8 param-tree transform;
- :mod:`~theanompi_torch.serving.lifecycle` — the request log, the queue
  file and the live snapshot (standard library only);
- :mod:`~theanompi_torch.serving.rollout` — verified live rollout with
  rollback;
- :mod:`~theanompi_torch.serving.cli` — ``python -m theanompi_torch.serving``.
"""

from theanompi_torch.serving.engine import InferenceEngine, sample_tokens
from theanompi_torch.serving.kv_cache import BlockPool, PagedKVCache, blocks_for
from theanompi_torch.serving.lifecycle import (
    RequestLog,
    SnapshotPublisher,
    terminal_records,
    terminal_rids,
)
from theanompi_torch.serving.prefix_cache import PrefixCache
from theanompi_torch.serving.quant import (
    dequantize_tree,
    is_quantized_tree,
    quantize_tree,
)
from theanompi_torch.serving.rollout import (
    RolloutManager,
    newest_manifest_epoch,
)
from theanompi_torch.serving.scheduler import (
    TERMINAL_STATES,
    Request,
    Scheduler,
    run_open_loop,
    run_queue_loop,
    serve_report,
)

__all__ = [
    "BlockPool", "InferenceEngine", "PagedKVCache", "PrefixCache",
    "Request", "RequestLog", "RolloutManager", "Scheduler",
    "SnapshotPublisher", "TERMINAL_STATES", "blocks_for",
    "dequantize_tree", "is_quantized_tree", "newest_manifest_epoch",
    "quantize_tree", "run_open_loop", "run_queue_loop", "sample_tokens",
    "serve_report", "terminal_records", "terminal_rids",
]
