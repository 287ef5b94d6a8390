"""Models of the port: the dense ``TransformerLM`` (training and serving)
on its PTB-style data, and the conv nets ``ResNet50`` and ``WideResNet``
on their image data (:mod:`theanompi_torch.models.data`)."""
