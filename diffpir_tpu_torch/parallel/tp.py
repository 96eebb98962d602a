"""Tensor-parallel (Megatron-style) sharding of the UNet's parameters.

Port of ``diffpir_tpu/parallel/tp.py``: the same specs over a ``model`` mesh
axis, the conv analogue of Megatron-LM's column/row split, chosen so that
everything between a block's boundary reductions stays on its shard.

ResBlock (reference ``unet.py:143-256``):
  * ``conv1`` column-parallel: weight (Cout, Cin, kh, kw) split on Cout;
  * ``emb_proj`` ROW-parallel: weight split on its input (time-embedding)
    dim, so its output is the full (B, 2C) after one all-reduce, and each
    rank takes its C/n channels of the scale half and of the shift half.
    Splitting the fused 2C output instead would give [scale|shift] blocks
    that do not line up with the channel shards;
  * ``norm2`` weight and bias split on C: GroupNorm(32) statistics stay on
    the shard when ``32 % n == 0``, as the groups are contiguous channel
    blocks (G/n groups a shard);
  * ``conv2`` row-parallel: weight split on Cin; partial sums, one
    all-reduce, then the bias once;
  * ``norm1`` and ``skip`` replicated (they act on the block's replicated
    input).

AttentionBlock (reference ``unet.py:259-305``): the legacy QKV layout is
head-major ([head][q|k|v][ch]), so splitting ``qkv``'s output dim is head
parallelism when ``num_heads % n == 0``; ``proj`` is row-parallel.

A block whose channel count, head count or ``32 % n`` does not divide
replicates its parameters; ``emb_proj`` alone replicates when its input dim
does not divide.  Specs are tuples naming, per dim of the port's tensor, the
mesh axis it is split over (None for none); ``()`` means replicated, as the
JAX package's ``P()``.

``shard_unet_params`` turns a UNet holding the full parameters into this
rank's: the sharded tensors become their slices, and the blocks learn their
mesh (``models/unet.py`` then runs the collectives).  Full JAX parameters
carried over with ``models/zoo.flax_to_torch`` and then sharded here compute
the JAX package's function.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from diffpir_tpu_torch.models.unet import AttentionBlock, ResBlock, UNet, UNetConfig
from diffpir_tpu_torch.parallel.mesh import Mesh, shard_tensor

__all__ = ["unet_tp_specs", "shard_unet_params", "tp_param_report", "nest"]

_REPLICATED = ()


def nest(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A flat ``{"a.b.weight": tensor}`` state dict as nested dicts."""
    out: Dict[str, Any] = {}
    for key, v in state.items():
        *path, leaf = key.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def _replicate_tree(sub) -> Any:
    if isinstance(sub, dict):
        return {k: _replicate_tree(v) for k, v in sub.items()}
    return _REPLICATED


def _resblock_specs(sub: Dict[str, Any], n_model: int, axis: str) -> Dict[str, Any]:
    out_ch = sub["conv1"]["weight"].shape[0]
    # groups must be whole per shard: 32 groups of out_ch/32 contiguous
    # channels, shards of out_ch/n contiguous channels
    if out_ch % n_model or 32 % n_model:
        return _replicate_tree(sub)
    specs: Dict[str, Any] = {
        "norm1": _replicate_tree(sub["norm1"]),
        "conv1": {"weight": (axis, None, None, None), "bias": (axis,)},
        "emb_proj": {"weight": (None, axis), "bias": _REPLICATED},
        "norm2": {"weight": (axis,), "bias": (axis,)},
        "conv2": {"weight": (None, axis, None, None), "bias": _REPLICATED},
    }
    if sub["emb_proj"]["weight"].shape[1] % n_model:
        specs["emb_proj"] = _replicate_tree(sub["emb_proj"])
    if "skip" in sub:
        specs["skip"] = _replicate_tree(sub["skip"])
    return specs


def _attention_specs(sub: Dict[str, Any], cfg: UNetConfig, n_model: int,
                     axis: str) -> Dict[str, Any]:
    ch = sub["qkv"]["weight"].shape[1]
    if cfg.heads_for(ch) % n_model:
        return _replicate_tree(sub)
    return {
        "norm": _replicate_tree(sub["norm"]),
        "qkv": {"weight": (axis, None), "bias": (axis,)},
        "proj": {"weight": (None, axis), "bias": _REPLICATED},
    }


# exact submodule-name sets, as the JAX package's (and models/convert.py's)
# strict detection: a module merely containing a qkv or conv1 must not match
_ATTN_KEYS = frozenset({"norm", "qkv", "proj"})
_RES_KEYS = frozenset({"norm1", "conv1", "emb_proj", "norm2", "conv2"})
_RES_KEYS_SKIP = _RES_KEYS | {"skip"}


def unet_tp_specs(state: Mapping[str, Any], cfg: UNetConfig, n_model: int,
                  axis: str = "model") -> Dict[str, Any]:
    """The spec tree of a UNet's parameters: ``state`` is its flat state
    dict (tensors, or anything with ``.shape``) or the same nested."""
    params = nest(state) if any("." in k for k in state) else dict(state)
    specs: Dict[str, Any] = {}
    for name, sub in params.items():
        keys = frozenset(sub) if isinstance(sub, dict) else None
        if keys == _ATTN_KEYS:
            specs[name] = _attention_specs(sub, cfg, n_model, axis)
        elif keys in (_RES_KEYS, _RES_KEYS_SKIP):
            specs[name] = _resblock_specs(sub, n_model, axis)
        else:
            # input_blocks_0_0, time_embed_*, out_norm, out_conv, label_emb,
            # resampling convs: small, replicated
            specs[name] = _replicate_tree(sub)
    return specs


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def tp_param_report(state: Mapping[str, Any], cfg: UNetConfig, n_model: int,
                    axis: str = "model") -> dict:
    """{'total', 'sharded', 'fraction'} parameter counts under the specs."""
    params = nest(state) if any("." in k for k in state) else dict(state)
    specs = dict(_leaves(unet_tp_specs(params, cfg, n_model, axis)))
    total = sharded = 0
    for path, p in _leaves(params):
        n = 1
        for d in p.shape:
            n *= int(d)
        total += n
        if any(d is not None for d in specs[path]):
            sharded += n
    return {"total": total, "sharded": sharded, "fraction": sharded / max(total, 1)}


def _slice(p: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    p = shard_tensor(p, spec, mesh)
    if p.ndim == 4:
        return p.contiguous(memory_format=torch.channels_last)
    return p.contiguous()


def shard_unet_params(model: UNet, mesh: Mesh, cfg: UNetConfig = None,
                      axis: str = "model") -> UNet:
    """Make ``model`` (holding the full parameters) this rank's shard of the
    UNet under ``mesh``'s ``axis``, in place, and return it: each sharded
    parameter becomes this rank's slice, and each sharded block is told its
    mesh, so that its forward runs the all-reduces (``models/unet.py``).
    ``model.param_specs`` then maps each parameter's name to its spec."""
    cfg = model.cfg if cfg is None else cfg
    n = mesh.axis_size(axis)
    if n == 1:
        return model
    specs = unet_tp_specs(model.state_dict(), cfg, n, axis)
    # every parameter's spec by name, as export.save_bundle records them
    model.param_specs = {".".join((name,) + path): s for name, spec in specs.items()
                         for path, s in _leaves(spec)}
    for name, spec in specs.items():
        block = getattr(model, name)
        if not isinstance(block, (ResBlock, AttentionBlock)):
            continue
        flat = dict(_leaves(spec))
        if not any(any(d is not None for d in s) for s in flat.values()):
            continue  # replicated fallback
        for path, s in flat.items():
            if not any(d is not None for d in s):
                continue
            mod = block
            for p in path[:-1]:
                mod = getattr(mod, p)
            old = getattr(mod, path[-1])
            setattr(mod, path[-1], torch.nn.Parameter(_slice(old.detach(), s, mesh),
                                                      requires_grad=old.requires_grad))
        emb_sharded = isinstance(block, ResBlock) and any(
            d is not None for d in flat[("emb_proj", "weight")])
        block.set_tensor_parallel(mesh, axis, emb_sharded=emb_sharded)
    return model
