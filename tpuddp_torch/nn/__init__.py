"""Neural-network pieces the port adds to ``torch.nn``."""

from tpuddp_torch.nn.loss import CrossEntropyLoss, cross_entropy  # noqa: F401
