"""MobileNet-V1 (small): the paper's mobile-regime model (Sec. 4.1), as a
CIFAR-sized depthwise-separable stack.  BOPs of the full ImageNet MobileNet
(paper Table 1) are ``repro_torch.core.bops.mobilenet_v1_imagenet``.
"""

from repro_torch.cnn.train import CNNExperiment


def experiment(**overrides) -> CNNExperiment:
    base = dict(model="mobilenet", width=16, steps=300, batch=128,
                lr=3e-3, noise=1.2)
    base.update(overrides)
    return CNNExperiment(**base)
