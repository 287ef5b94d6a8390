"""theanompi_torch: the PyTorch/CUDA port of ``theanompi_tpu``.

The JAX package stays the reference; this package re-implements its
slices in PyTorch for an NVIDIA H100, with every Pallas kernel on a
ported path replaced by a CUDA C++ kernel written for Hopper (sm_90a)
under :mod:`theanompi_torch.kernels`.

Slice 1 serves the dense ``TransformerLM`` end to end; slice 2 trains it
through the BSP rule on one card (:class:`BSP`, ``python -m
theanompi_torch.launcher``); slice 10 trains the conv nets, ResNet-50 and
the Wide-ResNet, through the same rule, and slice 17 the rest of the zoo
(AlexNet, VGG-16/11, GoogLeNet, the PTB LSTM, DCGAN/WGAN), and slice 20
the async rules, EASGD, LocalSGD and GOSGD:

- :mod:`theanompi_torch.parallel.mesh` — ``Precision`` policies and the
  device rule (``resolve_device``);
- :mod:`theanompi_torch.ops` — initializers, ``Dense``/``LayerNorm``/
  ``Embedding``, the conv nets' layers (``Conv2D``, ``ConvTranspose2D``,
  the pools, ``BatchNorm``, ``LRN``, ``Sequential``), ``LSTM``, the int8 weight format and matmul
  (kernel 5), flash attention forward (kernel 1), paged decode attention
  (kernel 4) and the attention layer;
- :mod:`theanompi_torch.models.contract` — the model contract
  (``Model``, ``SupervisedModel``), params and state;
- :mod:`theanompi_torch.models.transformer_lm` — the model's training and
  serving paths, on :mod:`theanompi_torch.models.lstm`'s ``PTBData``;
- :mod:`theanompi_torch.models.resnet50`,
  :mod:`theanompi_torch.models.wide_resnet`, ``alex_net``,
  ``vggnet_16``, ``googlenet`` and ``dcgan`` — the conv nets, on
  :mod:`theanompi_torch.models.data.imagenet` and
  :mod:`theanompi_torch.models.data.cifar10`;
- the data plane: the trainer's prefetcher
  (:mod:`theanompi_torch.models.data.prefetch`, pinned copies on a side
  stream), the shared-memory loader pool
  (:mod:`theanompi_torch.models.data.shm_loader`), the C crop
  (:mod:`theanompi_torch.native`) and the mixture token stream
  (:mod:`theanompi_torch.models.data.stream`);
- :mod:`theanompi_torch.ops.losses`, :mod:`theanompi_torch.ops.opt` — the
  fused chunked LM cross entropy, SGD;
- :mod:`theanompi_torch.parallel.bsp` — the BSP rule and its trainer;
  :mod:`theanompi_torch.parallel.easgd` and
  :mod:`theanompi_torch.parallel.gosgd` — the async rules (``EASGD``,
  ``LocalSGD``, ``GOSGD``) on :mod:`theanompi_torch.parallel.stacked`'s
  one-worker-a-rank layout; :mod:`theanompi_torch.launcher`, the port's
  ``tmlauncher`` (``--rule``);
- :mod:`theanompi_torch.utils.rulecomp` and
  :mod:`theanompi_torch.utils.converge` — the rules trained to a target,
  and the zoo's convergence rows (``CONVERGE_cuda.json``);
- :mod:`theanompi_torch.serving` — paged KV cache, engine, prefix cache,
  continuous-batching scheduler and the ``python -m
  theanompi_torch.serving`` CLI;
- :mod:`theanompi_torch.convert` — the reference's param and state trees
  into the port's and back.

Importing the package imports neither JAX nor anything that builds a
kernel: the CUDA sources compile at first use.
"""


#: the rules, by name, and the module that holds each
RULES = {"BSP": "theanompi_torch.parallel.bsp",
         "EASGD": "theanompi_torch.parallel.easgd",
         "LocalSGD": "theanompi_torch.parallel.easgd",
         "GOSGD": "theanompi_torch.parallel.gosgd"}


def __getattr__(name):
    # ``from theanompi_torch import BSP`` (or EASGD, LocalSGD, GOSGD),
    # imported on first use
    if name in RULES:
        import importlib

        return getattr(importlib.import_module(RULES[name]), name)
    raise AttributeError(f"module 'theanompi_torch' has no attribute "
                         f"{name!r}")
