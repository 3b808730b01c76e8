"""Branchy AlexNet — the paper's prototype model (Fig. 4).

A CIFAR-10-scale AlexNet trained with 5 exit points via BranchyNet-style
joint loss.  Branch lengths (number of layers from input to that exit),
longest to shortest: 22, 20, 19, 16, 12 — matching Sec. V-A of the paper.

This model is described by its own layer-graph spec (conv/LRN/pool/FC layers,
paper Table I layer types) rather than :class:`ModelConfig`; see
``repro_torch.models.alexnet``.
"""
from repro_torch.models.alexnet import BranchyAlexNetConfig

CONFIG = BranchyAlexNetConfig(
    name="branchy-alexnet",
    num_classes=10,
    image_size=32,
    channels=3,
)
