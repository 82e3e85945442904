"""ResNet-18 (narrow) on CIFAR-sized inputs: the paper's own ablation model
(Sec. 4.3 / App. A "narrow version of ResNet-18").

Not part of the LM registry; the CNNExperiment defaults of the paper-table
experiments.  BOPs of the full ImageNet ResNet-18 (paper Table 1) are
``repro_torch.core.bops.resnet18_imagenet``.
"""

from repro_torch.cnn.train import CNNExperiment


def experiment(**overrides) -> CNNExperiment:
    base = dict(model="resnet18", width=16, steps=300, batch=128,
                lr=3e-3, noise=1.2)
    base.update(overrides)
    return CNNExperiment(**base)
