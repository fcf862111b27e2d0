"""The two regressors as ``nn.Module``s in the reference's key schema.

The JAX package's names, less its Flax layer classes ``BatchNorm``,
``ConvBlock`` and ``DenseBNBlock``: the port builds the reference's
``nn.Sequential`` items with ``layers.conv_block`` and
``layers.dense_bn_block``, and its cross-replica BatchNorm is
``layers.CrossReplicaBatchNorm2d``/``1d``.
"""

from crosstalk_tpu_torch.models.registry import (
    architecture_summary,
    build_model,
    count_params,
    init_model,
    torch_style_repr,
)
from crosstalk_tpu_torch.models.single_branch import SingleBranchRegressor
from crosstalk_tpu_torch.models.two_branch import FeatureBranch, TwoBranchRegressor

__all__ = [
    "SingleBranchRegressor",
    "TwoBranchRegressor",
    "FeatureBranch",
    "build_model",
    "init_model",
    "count_params",
    "architecture_summary",
    "torch_style_repr",
]
