"""Models of the port: the dense ``TransformerLM`` (training and serving)
and the ``LSTM`` language model on their PTB-style data, and the conv
nets ``ResNet50``, ``WideResNet``, ``AlexNet``, ``VGGNet_16``/
``VGGNet_11_Shallow``, ``GoogLeNet`` and ``DCGAN``/``WGAN`` on their
image data (:mod:`theanompi_torch.models.data`)."""
