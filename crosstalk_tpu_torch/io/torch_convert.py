"""``.pth`` checkpoints (port of crosstalk_tpu/io/torch_convert.py).

The port's modules use the reference's state_dict key schema, so a ``.pth``
loads and saves natively. What stays here:

  * ``load_pth`` / ``save_pth`` with one clear error for an unreadable file;
  * the geometry helpers that size a model from its checkpoint;
  * ``from_jax_variables``: the JAX package's flax variables tree (as numpy
    arrays) -> a torch state_dict. It is the port's own copy of the JAX
    package's ``flax_to_torch`` mapping, used to feed the same weights to
    both packages;
  * ``from_jax_train_state``: the JAX package's whole train state (params,
    batch_stats, the optax Adam state, the step), as ``io/flax_msgpack``
    decodes it -> the port's resume-checkpoint payload.

torch state_dict key schema:
  single: conv_layers.{4k}.{weight,bias}  (Conv2d, k-th block)
          conv_layers.{4k+1}.{weight,bias,running_mean,running_var}  (BN2d)
          fc_layers.{1,5,9}.{weight,bias}  (Linear)  fc_layers.{2,6}.*  (BN1d)
  double: {bleed,source}_branch.conv_blocks.{4k}/{4k+1}.*  (4 blocks each)
          regression_head.fc_layers.{1,2,5,6,9}.*
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from crosstalk_tpu_torch.config import ModelConfig

StateDict = Dict[str, torch.Tensor]


def structure(variant: str) -> Tuple[list, str]:
    """-> ([(torch_conv_prefix, flax_branch_path)], torch_head_prefix)."""
    if variant == "single":
        return [("conv_layers", ())], "fc_layers"
    if variant == "double":
        return (
            [
                ("bleed_branch.conv_blocks", ("bleed_branch",)),
                ("source_branch.conv_blocks", ("source_branch",)),
            ],
            "regression_head.fc_layers",
        )
    raise ValueError(f"unknown variant {variant!r}")


def count_blocks(sd: StateDict, prefix: str) -> int:
    """Conv blocks under ``prefix``: Conv2d modules at Sequential indices
    0, 4, 8, ..."""
    n = 0
    while f"{prefix}.{4 * n}.weight" in sd:
        n += 1
    if n == 0:
        raise KeyError(f"no conv blocks found under {prefix!r}")
    return n


def load_pth(path: str) -> StateDict:
    """Read a ``.pth`` state_dict onto the CPU.

    Raises FileNotFoundError for a missing path and ValueError for a file
    that is not a torch checkpoint, so CLIs catch one clear type."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except FileNotFoundError:
        raise
    except Exception as e:  # UnpicklingError, BadZipFile, RuntimeError, ...
        raise ValueError(f"{path} is not a readable torch checkpoint: "
                         f"{type(e).__name__}: {e}") from e


def save_pth(path: str, state_dict: StateDict) -> None:
    """Write a state_dict as a ``.pth`` the reference's stack can load."""
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def infer_model_size(sd: StateDict, variant: str) -> dict:
    """Width/depth encoded in a checkpoint: ``{"initial_filters": w,
    "num_conv_blocks": n}`` for ``single``, ``{"initial_filters_per_branch":
    w}`` for ``double`` (its trunk depth is fixed), ``{}`` for ``swinv2-b``
    (its sizes are fixed; the checkpoint must hold its patch embedding)."""
    if variant == "swinv2-b":
        if "patch_embed.proj.weight" not in sd:
            raise KeyError("patch_embed.proj.weight: not a swinv2-b checkpoint")
        return {}
    if variant == "single":
        return {
            "initial_filters": int(sd["conv_layers.0.weight"].shape[0]),
            "num_conv_blocks": count_blocks(sd, "conv_layers"),
        }
    if variant == "double":
        return {"initial_filters_per_branch":
                int(sd["bleed_branch.conv_blocks.0.weight"].shape[0])}
    raise ValueError(f"unknown variant {variant!r}")


def checkpoint_tile_geometry(sd: StateDict, variant: str):
    """-> (head_spatial, pools): the post-trunk feature-map side length and
    pooling count baked into a checkpoint's head dimensions."""
    branches, head = structure(variant)
    dense_in = int(sd[f"{head}.1.weight"].shape[1])
    final_ch = 0
    for prefix, _ in branches:
        pools = count_blocks(sd, prefix)
        final_ch += int(sd[f"{prefix}.{4 * (pools - 1)}.weight"].shape[0])
    if dense_in % final_ch:
        raise ValueError(
            f"checkpoint head input dim {dense_in} is not a multiple of the "
            f"final conv width {final_ch} — corrupt or mismatched checkpoint"
        )
    spatial_sq = dense_in // final_ch
    spatial = int(round(spatial_sq ** 0.5))
    if spatial * spatial != spatial_sq:
        raise ValueError(
            f"checkpoint head input dim {dense_in} implies a non-square "
            f"{spatial_sq}-pixel feature map — corrupt or mismatched checkpoint"
        )
    return spatial, pools


# swinv2-b's weights hold no tile size: it takes a multiple of 32 pixels of
# at least 64 (patch 4, three merges, a last map of 2 x 2 tokens or more)
# and was configured at 256
SWIN_IMAGE_SIZE = 256


def image_size_compatible(sd: StateDict, variant: str, px: int) -> bool:
    """Whether ``px``-sized tiles feed this checkpoint's head exactly.

    Each max pool floors odd sides, so every px in
    ``[spatial*2**pools, (spatial+1)*2**pools - 1]`` pools down to the same
    head spatial size."""
    if variant == "swinv2-b":
        return px % 32 == 0 and px >= 64
    spatial, pools = checkpoint_tile_geometry(sd, variant)
    x = px
    for _ in range(pools):
        x //= 2
    return x == spatial


def infer_image_size(sd: StateDict, variant: str) -> int:
    """Tile size a checkpoint was trained at (the smallest compatible size
    when it is not a multiple of ``2**pools``; ``SWIN_IMAGE_SIZE`` for
    swinv2-b)."""
    if variant == "swinv2-b":
        return SWIN_IMAGE_SIZE
    spatial, pools = checkpoint_tile_geometry(sd, variant)
    return spatial * (2 ** pools)


def compatible_px_range(sd: StateDict, variant: str) -> Tuple[int, int]:
    """-> (smallest, largest) tile size that ``image_size_compatible`` takes."""
    spatial, pools = checkpoint_tile_geometry(sd, variant)
    return spatial * 2 ** pools, (spatial + 1) * 2 ** pools - 1


def model_config_for_checkpoint(
    variant: str,
    sd: StateDict,
    *,
    initial_filters=None,
    num_conv_blocks=None,
    compute_dtype: str = "bf16",
) -> ModelConfig:
    """ModelConfig sized to a loaded checkpoint. Size flags, when given, are
    validated against it (ValueError naming both sizes on a mismatch)."""
    if num_conv_blocks is not None and variant != "single":
        raise ValueError(
            "num_conv_blocks applies to the single-branch model only "
            "(the two-branch trunk is fixed at 4 blocks per branch)"
        )
    if initial_filters is not None and variant == "swinv2-b":
        raise ValueError("initial_filters applies to the conv models only, not 'swinv2-b'")
    detected = infer_model_size(sd, variant)
    width_key = ("initial_filters" if variant == "single"
                 else "initial_filters_per_branch")
    if initial_filters is not None and initial_filters != detected[width_key]:
        raise ValueError(
            f"--initial_filters {initial_filters} does not match the "
            f"checkpoint (trained with {detected[width_key]})"
        )
    if num_conv_blocks is not None and (
        num_conv_blocks != detected["num_conv_blocks"]
    ):
        raise ValueError(
            f"--num_conv_blocks {num_conv_blocks} does not match the "
            f"checkpoint (trained with {detected['num_conv_blocks']})"
        )
    return ModelConfig(variant=variant, compute_dtype=compute_dtype,
                       **detected)


def _first_dense_w_inv(k: np.ndarray, channels: int) -> np.ndarray:
    """(H*W*C, out) flax kernel -> (out, C*H*W) torch weight: flax flattens
    NHWC as (H, W, C), torch flattens NCHW as (C, H, W). The feature map is
    square, as in every config the reference instantiates."""
    flat, out = k.shape
    hw = flat // channels
    side = int(math.isqrt(hw))
    if side * side != hw:
        raise ValueError(f"non-square flatten: {flat} / {channels} channels")
    return (
        k.reshape(side, side, channels, out)
        .transpose(3, 2, 0, 1)
        .reshape(out, flat)
    )


def _count_flax_blocks(tree: dict) -> int:
    n = 0
    while f"ConvBlock_{n}" in tree:
        n += 1
    if n == 0:
        raise KeyError("no ConvBlock_* entries in params tree")
    return n


def _get(tree: dict, path: tuple) -> np.ndarray:
    node = tree
    for key in path:
        node = node[key]
    if isinstance(node, torch.Tensor):  # a bf16 leaf (io/flax_msgpack)
        return node.float().numpy()
    return np.asarray(node, dtype=np.float32)


def from_jax_variables(variables: dict, variant: str) -> StateDict:
    """flax variables ``{'params': ..., 'batch_stats': ...}`` (nested dicts
    of arrays) -> a torch state_dict of float32 CPU tensors.

    Conv kernels go HWIO -> OIHW, dense kernels are transposed, and the
    first head kernel is permuted from the (H, W, C) to the (C, H, W)
    flatten order."""
    params, stats = variables["params"], variables["batch_stats"]
    branches, head = structure(variant)
    sd: Dict[str, np.ndarray] = {}

    def bn(prefix: str, block: tuple) -> None:
        sd[f"{prefix}.weight"] = _get(params, block + ("BatchNorm_0", "scale"))
        sd[f"{prefix}.bias"] = _get(params, block + ("BatchNorm_0", "bias"))
        sd[f"{prefix}.running_mean"] = _get(stats, block + ("BatchNorm_0", "mean"))
        sd[f"{prefix}.running_var"] = _get(stats, block + ("BatchNorm_0", "var"))
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)

    flat_channels = 0
    for torch_prefix, flax_branch in branches:
        branch_tree = params
        for key in flax_branch:
            branch_tree = branch_tree[key]
        n_blocks = _count_flax_blocks(branch_tree)
        for b in range(n_blocks):
            block = flax_branch + (f"ConvBlock_{b}",)
            kernel = _get(params, block + ("Conv_0", "kernel"))
            sd[f"{torch_prefix}.{4 * b}.weight"] = kernel.transpose(3, 2, 0, 1)
            sd[f"{torch_prefix}.{4 * b}.bias"] = _get(params, block + ("Conv_0", "bias"))
            bn(f"{torch_prefix}.{4 * b + 1}", block)
            if b == n_blocks - 1:
                flat_channels += kernel.shape[-1]

    for i, (lin, bn_idx) in enumerate([(1, 2), (5, 6)]):
        block = (f"DenseBNBlock_{i}",)
        kernel = _get(params, block + ("Dense_0", "kernel"))
        sd[f"{head}.{lin}.weight"] = (
            _first_dense_w_inv(kernel, flat_channels) if i == 0 else kernel.T
        )
        sd[f"{head}.{lin}.bias"] = _get(params, block + ("Dense_0", "bias"))
        bn(f"{head}.{bn_idx}", block)

    sd[f"{head}.9.weight"] = _get(params, ("Dense_0", "kernel")).T
    sd[f"{head}.9.bias"] = _get(params, ("Dense_0", "bias"))
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _leaf_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaf_count(v) for v in tree.values())
    return 1


_TRAIN_STATE_KEYS = {"params", "batch_stats", "opt_state", "step"}
_ADAM_KEYS = {"count", "mu", "nu"}


def from_jax_train_state(tree: dict, variant: str) -> dict:
    """The JAX package's ``TrainState`` state dict (``{'params',
    'batch_stats', 'opt_state', 'step'}``, numpy leaves) -> the payload
    ``io.checkpoint.state_payload`` builds, without its ``'rng'``: ``{'model':
    state_dict, 'optimizer': torch Adam state_dict, 'step': int}``. The JAX
    key does not carry over (the two packages' random streams differ by
    design) and a resume reads no ``'rng'``: the loop's next checkpoint
    writes its own seed.

    The optax state is ``(add_decayed_weights, scale_by_adam)``'s, ``{'0':
    {}, '1': {'count', 'mu', 'nu'}}`` (crosstalk_tpu/train/steps.py:44-52).
    ``mu`` and ``nu`` have the params' tree and take the same layout
    conversion, a permutation of elements, so the moments move exactly;
    they become Adam's ``exp_avg`` / ``exp_avg_sq`` in the order of the
    model's parameters, and ``count`` each parameter's ``step``, a host
    tensor as torch keeps it. Adam's hyperparameters are ``OptimConfig``'s
    defaults, the ones both packages train with (the learning rate is set
    before every step). A tree of another shape raises ValueError: it is
    never taken for a fresh state."""
    from crosstalk_tpu_torch.config import OptimConfig
    from crosstalk_tpu_torch.models.registry import build_model
    from crosstalk_tpu_torch.train.steps import make_optimizer

    if not isinstance(tree, dict) or set(tree) != _TRAIN_STATE_KEYS:
        raise ValueError(f"not a crosstalk_tpu TrainState: top-level keys "
                         f"{sorted(tree) if isinstance(tree, dict) else type(tree)}, "
                         f"expected {sorted(_TRAIN_STATE_KEYS)}")
    opt = tree["opt_state"]
    if (not isinstance(opt, dict) or set(opt) != {"0", "1"} or opt["0"] != {}
            or not isinstance(opt["1"], dict) or set(opt["1"]) != _ADAM_KEYS):
        raise ValueError("not the optax state of crosstalk_tpu.train.steps."
                         "make_optimizer (add_decayed_weights, scale_by_adam): "
                         f"{opt if not isinstance(opt, dict) else sorted(opt)}")
    adam = opt["1"]
    try:
        sd = from_jax_variables(
            {"params": tree["params"], "batch_stats": tree["batch_stats"]}, variant)
        moments = [from_jax_variables({"params": adam[k], "batch_stats": tree["batch_stats"]},
                                      variant) for k in ("mu", "nu")]
    except (KeyError, ValueError) as e:
        raise ValueError(f"JAX train state of an unknown {variant} tree: {e}") from None
    model = build_model(model_config_for_checkpoint(variant, sd),
                        image_size=infer_image_size(sd, variant), device="meta")
    names = [n for n, _ in model.named_parameters()]
    buffers = [n for n, _ in model.named_buffers() if not n.endswith("num_batches_tracked")]
    for subtree, want, what in ((tree["params"], names, "params"),
                                (tree["batch_stats"], buffers, "batch_stats"),
                                (adam["mu"], names, "mu"), (adam["nu"], names, "nu")):
        if _leaf_count(subtree) != len(want):
            raise ValueError(f"JAX {what} tree has {_leaf_count(subtree)} leaves, the "
                             f"{variant} model {len(want)}: an unknown tree")
    count = torch.tensor(float(np.asarray(adam["count"])))
    optimizer = make_optimizer(model.parameters(), OptimConfig()).state_dict()
    optimizer["state"] = {
        i: {"step": count.clone(), "exp_avg": moments[0][n], "exp_avg_sq": moments[1][n]}
        for i, n in enumerate(names)
    }
    return {"model": sd, "optimizer": optimizer, "step": int(np.asarray(tree["step"]))}
