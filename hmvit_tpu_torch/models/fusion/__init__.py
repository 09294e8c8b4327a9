"""Cooperative BEV fusion zoo (port of ``hmvit_tpu/models/fusion``).

Every module shares one interface:
    forward(x, mode, pairwise, agent_mask) -> fused ego BEV (B, H, W, C)
with x (B, L, H, W, C) per-agent features in their own frames,
pairwise[b, j, i] agent j -> agent i's frame, agent_mask (B, L); each is
an alternative to H3GAT above the same interface.
"""
from .basic import AttFusion, DiscoNetFusion, SpatialFusion  # noqa: F401
from .swap import SwapFusionEncoder  # noqa: F401
from .v2vnet import V2VNetFusion  # noqa: F401
from .v2xvit import V2XTransformer  # noqa: F401

# the registry names of make_fusion, each with the JAX package's aliases
FUSION_NAMES = ("fcooper", "att", "self_att", "disconet", "v2vnet", "swap",
                "fax", "cobevt", "v2xvit", "v2xt")


def _dim_head(dim: int) -> int:
    for d in (32, 16, 8, 4, 2, 1):
        if dim % d == 0:
            return d
    return 1


def make_fusion(name: str, dim: int, spatial: dict, args: dict = None,
                prior_encoding: bool = False):
    """The fusion module of registry name ``name`` on ``dim`` channels;
    ``spatial`` is the config's ``spatial_transform`` block, ``args`` the
    fusion's own block (DiscoNet's ``num_iteration`` / ``use_mask``).
    ``prior_encoding``: V2X-ViT takes the agents' (velocity, delay,
    infra) context (the JAX module builds that branch when it is first
    called with it)."""
    args = args or {}
    ratio = spatial.get("voxel_size", [0.4])[0]
    ds = spatial.get("downsample_rate", 4)
    if name == "fcooper":
        return SpatialFusion(discrete_ratio=ratio, downsample_rate=ds)
    if name in ("att", "self_att"):
        return AttFusion(dim, discrete_ratio=ratio, downsample_rate=ds)
    if name == "disconet":
        return DiscoNetFusion(
            dim, discrete_ratio=ratio, downsample_rate=ds,
            num_iteration=int(args.get("num_iteration", 1)),
            use_mask=bool(args.get("use_mask", True)))
    if name == "v2vnet":
        return V2VNetFusion(dim, discrete_ratio=ratio, downsample_rate=ds)
    if name in ("swap", "fax", "cobevt"):
        return SwapFusionEncoder(dim, dim_head=_dim_head(dim),
                                 discrete_ratio=ratio, downsample_rate=ds)
    if name in ("v2xvit", "v2xt"):
        return V2XTransformer(dim, discrete_ratio=ratio, downsample_rate=ds,
                              prior_encoding=prior_encoding)
    raise ValueError(f"unknown fusion {name!r}")
