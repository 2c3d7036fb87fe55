"""Tensor-parallel sharding over ``torch.distributed`` (counterpart of
``mquant_tpu/parallel/sharding.py``).

JAX writes PartitionSpecs over a ("dp", "tp") device mesh and lets GSPMD
place the collectives. The port runs one process per rank with explicit
Megatron sharding: each rank holds a smaller local model (its query and KV
heads, its intermediate columns, its vocabulary columns), runs the same
kernels at those shapes, and the layers call :mod:`.collectives` where GSPMD
would put them:

* column-parallel sites (the out axis split: q / k / v, gate / up, the ViT's
  q / k / v / fc1, the merger's mlp0, the resampler's kv_proj / q / k / v,
  the projectors' first products, the lm_head over the vocabulary) run
  unchanged on their columns. The lm_head's logits, the ViT's patch embed
  and the resampler's kv_proj are gathered after (:data:`GATHERED_SITES`:
  the caller or a norm needs whole rows);
* row-parallel sites (the in axis split: o, down, the ViT's o / fc2, mlp2,
  the resampler's out / proj_fc, the projectors' second products) reduce
  across the tp row inside ``models.layers.qlinear``: int32 accumulators in
  real mode (exact), f32 partials in fp and fake mode.

The spec maps are JAX's, copied as data: a spec (:class:`P`) names the mesh
axis of each array axis (None: replicated). :func:`shard_params` cuts this
rank's slice by them, except where an even cut would not give whole heads or
an exact local product:

* KV heads replicate where tp > n_kv_heads: rank r holds KV head
  r // (tp / n_kv_heads) (tp % n_kv_heads == 0);
* the lm_head's vocabulary pads to a multiple of 16 · tp with zero columns
  (unit scales), dropped from the gathered logits;
* the RMS split's ``down`` (``w_col0`` plus the rows of channels 1..K−1)
  splits over the original K axis, so each rank owns the channels its gate
  / up produced and rank 0 owns channel 0; ``w_col0`` stays on every rank,
  which adds the x0 · w_col0 term once, after the reduce;
* packed W4 rows (split-half: byte row i holds code rows i and i + K/2) of
  a row-parallel site are unpacked, cut, and packed again.

A grouped-query cut that leaves fractions of heads, or any width tp does not
divide, raises naming it. :func:`set_mesh` makes a mesh current for the
calling thread, as ``jax.set_mesh``: the layers read it
(:func:`tp_mesh`), and a server's scheduler thread enters it as JAX's does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import torch


class P(tuple):
    """A partition spec as data (JAX's ``PartitionSpec``): one entry per
    array axis, the mesh axis it is cut over ("tp") or None (replicated);
    ``P()`` replicates every axis."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, tp) grid of ranks and this rank's place in it. ``tp_group`` /
    ``dp_group``: the process groups of this rank's tp row and dp column
    (None where the mesh only describes a slice, :func:`slice_mesh`);
    ``tp_ranks`` / ``dp_ranks``: their global ranks; ``group``: the group
    the grid was made over (None: the default group)."""

    dp: int
    tp: int
    dp_index: int = 0
    tp_index: int = 0
    tp_group: Any = None
    dp_group: Any = None
    tp_ranks: Tuple[int, ...] = ()
    dp_ranks: Tuple[int, ...] = ()
    group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def index(self) -> int:
        """This rank's place in the whole grid, row-major (dp, tp)."""
        return self.dp_index * self.tp + self.tp_index


def slice_mesh(tp_index: int, tp: int, dp_index: int = 0, dp: int = 1
               ) -> Mesh:
    """A mesh that only says where this rank sits: enough for
    :func:`shard_params` and :func:`local_config` with no process group."""
    return Mesh(dp=dp, tp=tp, dp_index=dp_index, tp_index=tp_index)


def make_mesh(tp: Optional[int] = None, group=None) -> Mesh:
    """A (dp, tp) grid over the ranks of ``group`` (None: the initialized
    default group), tp defaulting to all of them (pure TP). Rank i of the
    group sits at (i // tp, i % tp). Makes one process group for each tp
    row and each dp column, every rank creating all of them in the same
    order (``dist.new_group``'s rule). The backend is the caller's: the mesh
    takes the process group it was given and picks none itself."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call torch.distributed."
                           "init_process_group first")
    ranks = (list(range(dist.get_world_size())) if group is None
             else list(dist.get_process_group_ranks(group)))
    n = len(ranks)
    tp = tp or n
    if n % tp:
        raise ValueError(f"make_mesh: {n} ranks do not split into tp={tp}")
    me = dist.get_rank()
    if me not in ranks:
        raise ValueError(f"make_mesh: rank {me} is not in the group")
    rows = [tuple(ranks[i * tp:(i + 1) * tp]) for i in range(n // tp)]
    cols = [tuple(ranks[j::tp]) for j in range(tp)]
    tp_group = dp_group = None
    tp_ranks = dp_ranks = ()
    for row in rows:
        g = dist.new_group(list(row))
        if me in row:
            tp_group, tp_ranks = g, row
    for col in cols:
        g = dist.new_group(list(col))
        if me in col:
            dp_group, dp_ranks = g, col
    pos = ranks.index(me)
    return Mesh(dp=n // tp, tp=tp, dp_index=pos // tp, tp_index=pos % tp,
                tp_group=tp_group, dp_group=dp_group, tp_ranks=tp_ranks,
                dp_ranks=dp_ranks, group=group)


# ---------------------------------------------------------------------------
# the current mesh
# ---------------------------------------------------------------------------

_LOCAL = threading.local()


@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` current for this thread (``jax.set_mesh``): the layers
    of a forward under it run this rank's part and call the collectives."""
    prev = getattr(_LOCAL, "mesh", None)
    _LOCAL.mesh = mesh
    try:
        yield mesh
    finally:
        _LOCAL.mesh = prev


def tp_mesh() -> Optional[Mesh]:
    """The mesh this thread is under where it splits the model (tp > 1),
    else None: the layers' test for the sharded path."""
    m = getattr(_LOCAL, "mesh", None)
    return m if m is not None and m.tp > 1 else None


def refuse_under_mesh(what: str, item: str) -> None:
    """Raise for a path the sharded forward does not take."""
    if tp_mesh() is not None:
        raise NotImplementedError(f"{what} under a tensor-parallel mesh is "
                                  f"not ported (ROADMAP {item})")


# ---------------------------------------------------------------------------
# the spec maps (JAX's, as data)
# ---------------------------------------------------------------------------

# PartitionSpec per decoder site (stacked weights (L, in, out))
_DECODER_PARAM_SPECS = {
    "embed": {"w": P(None, None)},  # replicated
    "layers": {
        "ln1": {"w": P(None, None)},
        "q": {"w": P(None, None, "tp"), "b": P(None, "tp")},
        "k": {"w": P(None, None, "tp"), "b": P(None, "tp")},
        "v": {"w": P(None, None, "tp"), "b": P(None, "tp")},
        "o": {"w": P(None, "tp", None), "b": P(None, None)},
        "ln2": {"w": P(None, None)},
        "gate": {"w": P(None, None, "tp"), "b": P(None, "tp")},
        "up": {"w": P(None, None, "tp"), "b": P(None, "tp")},
        "down": {"w": P(None, "tp", None), "b": P(None, None),
                 "w_col0": P(None, None, None)},
    },
    "ln_f": {"w": P(None)},
    "lm_head": {"w": P(None, "tp"), "b": P("tp")},
}

# ViT blocks follow the same column / row pattern
_VIT_PARAM_SPECS = {
    "patch_embed": {"w": P(None, "tp"), "b": P("tp")},
    "pos_embed": {"w": P(None, None)},
    "ln_pre": {"w": P(None), "b": P(None)},
    "ln_post": {"w": P(None), "b": P(None)},
    "fc_sub_mean": {"w": P(None, None)},
    "blocks": {
        "ln1": {"w": P(None, None), "b": P(None, None)},
        "q": {"w": P(None, None, "tp"), "b": P(None, "tp")},
        "k": {"w": P(None, None, "tp"), "b": P(None, "tp")},
        "v": {"w": P(None, None, "tp"), "b": P(None, "tp")},
        "o": {"w": P(None, "tp", None), "b": P(None, None)},
        "ls1": {"w": P(None, None)},
        "ls2": {"w": P(None, None)},
        "ln2": {"w": P(None, None), "b": P(None, None)},
        "fc1": {"w": P(None, None, "tp"), "b": P(None, "tp")},
        "fc2": {"w": P(None, "tp", None), "b": P(None, None)},
    },
}

_MERGER_PARAM_SPECS = {
    "ln_q": {"w": P(None), "b": P(None)},
    "mlp0": {"w": P(None, "tp"), "b": P("tp")},
    "mlp2": {"w": P("tp", None), "b": P(None)},
}

# the Qwen-VL attn_pool / MiniCPM-V resampler: kv_proj / q / k / v column
# split (heads across ranks), out / proj_fc row split, the learned query and
# position tables replicated
_RES_PARAM_SPECS = {
    "query": {"w": P(None, None)},
    "pos_embed_kv": {"w": P(None, None)},
    "kv_proj": {"w": P(None, "tp"), "b": P("tp")},
    "q": {"w": P(None, "tp"), "b": P("tp")},
    "k": {"w": P(None, "tp"), "b": P("tp")},
    "v": {"w": P(None, "tp"), "b": P("tp")},
    "out": {"w": P("tp", None), "b": P(None)},
    "proj_fc": {"w": P("tp", None), "b": P(None)},
    "ln_q": {"w": P(None), "b": P(None)},
    "ln_kv": {"w": P(None), "b": P(None)},
    "ln_post": {"w": P(None), "b": P(None)},
}

# InternVL mlp1: a Megatron column → row pair
_PROJ_MLP1_PARAM_SPECS = {
    "ln": {"w": P(None), "b": P(None)},
    "fc1": {"w": P(None, "tp"), "b": P("tp")},
    "fc2": {"w": P("tp", None), "b": P(None)},
}

# GLM-4V's GLU projector: conv column → linear_proj row, gate / h_to_4h
# column → 4h_to_h row; norms and boi / eoi replicated
_PROJ_GLU_PARAM_SPECS = {
    "conv": {"w": P(None, "tp"), "b": P("tp")},
    "linear_proj": {"w": P("tp", None), "b": P(None)},
    "norm1": {"w": P(None), "b": P(None)},
    "gate": {"w": P(None, "tp"), "b": P("tp")},
    "h_to_4h": {"w": P(None, "tp"), "b": P("tp")},
    "4h_to_h": {"w": P("tp", None), "b": P(None)},
    "boi": {"w": P(None, None)},
    "eoi": {"w": P(None, None)},
}

# the site maps by the prefix of a quant site's name (``models.layers``)
_SITE_MAPS = {
    "llm": {**_DECODER_PARAM_SPECS["layers"],
            "lm_head": _DECODER_PARAM_SPECS["lm_head"]},
    "vis": {**_VIT_PARAM_SPECS["blocks"],
            "patch_embed": _VIT_PARAM_SPECS["patch_embed"]},
    "merger": _MERGER_PARAM_SPECS,
    "res": _RES_PARAM_SPECS,
    "proj": {**_PROJ_MLP1_PARAM_SPECS, **_PROJ_GLU_PARAM_SPECS},
}

# column-parallel sites whose output is gathered right after the product
GATHERED_SITES = frozenset({"llm.lm_head", "vis.patch_embed",
                            "res.kv_proj"})


def _kind(wspec) -> Optional[str]:
    """"row" (in axis split), "col" (out axis split) or None (replicated)
    for a weight's spec."""
    if wspec is None or len(wspec) < 2:
        return None
    if wspec[-2] == "tp":
        return "row"
    return "col" if wspec[-1] == "tp" else None


def site_kind(name: str) -> Optional[str]:
    """:func:`_kind` of a quant site by its name ("llm.o", ...); None for a
    name outside the maps."""
    prefix, _, site = name.partition(".")
    return _kind(_SITE_MAPS.get(prefix, {}).get(site, {}).get("w"))


def _spec_tree_for(params: Dict, spec_map: Dict) -> Dict:
    """Match the spec map against the params' structure (missing entries
    replicated; the integer storage ``w_q`` and the dequant tables
    ``w_scale`` / ``w_zp`` inherit w's cut of their last (out) axis;
    ``a_fold`` and the act_order ``a_perm`` replicated): JAX's rule."""
    out = {}
    for k, v in params.items():
        m = spec_map.get(k, None)
        if v is None:
            out[k] = None
        elif isinstance(v, dict):
            if isinstance(m, dict):
                sub = dict(m)
                if "w" in m and isinstance(m.get("w"), P):
                    wspec = m["w"]
                    sub.setdefault("w_q", wspec)
                    outax = wspec[-1] if len(wspec) >= 2 else None
                    for aux in ("w_scale", "w_zp"):
                        if aux in v and aux not in sub and v[aux] is not None:
                            nd = getattr(v[aux], "ndim", 0)
                            sub[aux] = (P(*([None] * (nd - 1)), outax) if nd
                                        else P())
                    if "a_fold" in v:
                        sub.setdefault("a_fold", P())
                    if "a_perm" in v:
                        sub.setdefault("a_perm", P())
                out[k] = _spec_tree_for(v, sub)
            else:
                out[k] = _spec_tree_for(v, {})
        else:
            out[k] = m if m is not None else P()
    return out


def decoder_param_specs(params: Dict) -> Dict:
    return _spec_tree_for(params, _DECODER_PARAM_SPECS)


def vlm_param_specs(params: Dict) -> Dict:
    """Spec tree of a whole VLM params tree, every family: llm, vit, merger
    (Qwen2-VL), res (Qwen-VL / MiniCPM-V), proj (InternVL's mlp1 or
    GLM-4V's GLU projector, told apart by their keys)."""
    out = {}
    if "llm" in params:
        out["llm"] = _spec_tree_for(params["llm"], _DECODER_PARAM_SPECS)
    if "vit" in params:
        out["vit"] = _spec_tree_for(params["vit"], _VIT_PARAM_SPECS)
    if "merger" in params:
        out["merger"] = _spec_tree_for(params["merger"], _MERGER_PARAM_SPECS)
    if "res" in params:
        out["res"] = _spec_tree_for(params["res"], _RES_PARAM_SPECS)
    if "proj" in params:
        pmap = (_PROJ_GLU_PARAM_SPECS if "linear_proj" in params["proj"]
                else _PROJ_MLP1_PARAM_SPECS)
        out["proj"] = _spec_tree_for(params["proj"], pmap)
    return out


# ---------------------------------------------------------------------------
# local configs and slices
# ---------------------------------------------------------------------------


def _div(width: int, tp: int, what: str) -> int:
    if width % tp:
        raise ValueError(f"{what} = {width} is not divisible by tp = {tp}")
    return width // tp


def _kv_local(n_heads: int, n_kv: int, tp: int, what: str) -> int:
    """KV heads a rank holds: n_kv / tp, or 1 replicated head where
    tp > n_kv (tp % n_kv == 0)."""
    _div(n_heads, tp, f"{what}.n_heads")
    if n_kv >= tp:
        return _div(n_kv, tp, f"{what}.n_kv_heads")
    if tp % n_kv:
        raise ValueError(f"{what}.n_kv_heads = {n_kv} neither divides nor "
                         f"is a divisor of tp = {tp}")
    return 1


def whole_kv_heads(cfg, mesh: Mesh) -> int:
    """The whole model's KV heads of a rank's local decoder config: the
    count :func:`local_config` noted on it (where KV heads replicate the
    local config holds one), else local × tp."""
    return getattr(cfg, "_whole_kv_heads", cfg.n_kv_heads * mesh.tp)


def local_config(cfg, mesh: Mesh):
    """The config of this rank's local model: the decoder's heads, KV heads
    (one replicated head where tp > n_kv_heads) and intermediate width, the
    ViT's heads and MLP width, divided by tp (head_dim kept); vocabularies
    stay whole (the logits are gathered). A family config gets its towers
    localized and every other split width checked. Raises naming a width
    tp does not divide."""
    from ..models.llm import DecoderConfig
    from ..models.vision import ViTConfig

    tp = mesh.tp
    if tp == 1:
        return cfg
    if isinstance(cfg, DecoderConfig):
        local = dataclasses.replace(
            cfg, n_heads=_div(cfg.n_heads, tp, "llm.n_heads"),
            n_kv_heads=_kv_local(cfg.n_heads, cfg.n_kv_heads, tp, "llm"),
            intermediate=_div(cfg.intermediate, tp, "llm.intermediate"),
            intermediate_pad=_div(cfg.intermediate_pad, tp,
                                  "llm.intermediate_pad"),
            head_dim=cfg.head_dim)
        # not a field: the config's fields are the artifact's config dict
        object.__setattr__(local, "_whole_kv_heads", cfg.n_kv_heads)
        return local
    if isinstance(cfg, ViTConfig):
        _div(cfg.width, tp, "vit.width")
        return dataclasses.replace(
            cfg, n_heads=_div(cfg.n_heads, tp, "vit.n_heads"),
            mlp_width=_div(cfg.mlp_width, tp, "vit.mlp_width"),
            head_dim=cfg.head_dim)
    rep = {}
    for f in dataclasses.fields(cfg):
        sub = getattr(cfg, f.name)
        if isinstance(sub, (DecoderConfig, ViTConfig)):
            rep[f.name] = local_config(sub, mesh)
        elif f.name == "resampler":
            _div(sub.n_heads, tp, "res.n_heads")
            _div(sub.width, tp, "res.width")
        elif f.name == "merger":
            _div(sub.in_dim, tp, "merger.in_dim")
        elif f.name == "mlp1":
            _div(sub.out_dim, tp, "proj.out_dim")
        elif f.name == "proj":
            _div(sub.out_dim, tp, "proj.out_dim")
            _div(sub.ffn_dim, tp, "proj.ffn_dim")
    return dataclasses.replace(cfg, **rep) if rep else cfg


def _cut(t: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    return t.narrow(axis, lo, hi - lo).contiguous()


def row_bounds(K: int, tp: int, r: int, split: bool) -> Tuple[int, int]:
    """The stored rows [lo, hi) of rank r for a row-parallel site over an
    input of K channels: the chunk r of K / tp channels; with the RMS split
    the stored rows are channels 1..K−1, so rank 0 holds K / tp − 1 of them
    and channel 0 is ``w_col0``."""
    n = _div(K, tp, "a row-parallel input")
    lo, hi = r * n, (r + 1) * n
    return (max(lo - 1, 0), hi - 1) if split else (lo, hi)


def vocab_padded(vocab: int, tp: int) -> int:
    """The vocabulary padded to a multiple of 16 · tp (each rank's slice a
    multiple of 16, the W4 GEMV's channel granularity)."""
    step = 16 * tp
    return -(-vocab // step) * step


def _shard_site(site: Dict, spec: Dict, path: str, r: int, tp: int,
                llm_cfg) -> Dict:
    """This rank's part of one site dict."""
    if site.get("w_q_fused") is not None:
        raise ValueError(f"{path}: shard the tree before prepare_w4_resident "
                         "fuses its groups")
    kind = _kind(spec.get("w") or spec.get("w_q"))
    if kind is None:
        return dict(site)
    out = dict(site)
    name = path.rsplit(".", 1)[-1]
    is_llm = path.startswith("llm.")
    if kind == "col":
        lo_hi = None
        ref = site["w"] if site.get("w") is not None else site["w_q"]
        N = ref.shape[-1]
        if is_llm and name == "lm_head":
            Np = vocab_padded(N, tp)
            if Np != N:
                out = {k: _pad_cols(k, v, Np) for k, v in site.items()}
            N = Np
        if (is_llm and llm_cfg is not None and name in ("k", "v")
                and llm_cfg.n_kv_heads < tp):
            hd = llm_cfg.head_dim
            h = r // (tp // llm_cfg.n_kv_heads)
            lo_hi = (h * hd, (h + 1) * hd)
        if lo_hi is None:
            n = _div(N, tp, f"{path} width")
            lo_hi = (r * n, (r + 1) * n)
        for k in ("w", "w_q", "b", "w_scale", "w_zp", "a_corr"):
            v = out.get(k)
            if isinstance(v, torch.Tensor) and v.ndim >= 1:
                out[k] = _cut(v, -1, *lo_hi)
        return out
    # row-parallel
    from ..kernels.qmm import pack_int4_split, unpack_int4_weights

    split = "w_col0" in site
    for k in ("w", "w_q"):
        v = site.get(k)
        if not isinstance(v, torch.Tensor):
            continue
        rows = v.shape[-2]
        packed = False
        if (k == "w_q" and is_llm and llm_cfg is not None and not split
                and rows * 2 == llm_cfg.in_dims.get(name, -1)):
            packed = True
            v = unpack_int4_weights({"w_q": v})
            rows = v.shape[-2]
        K = rows + 1 if split else rows
        lo, hi = row_bounds(K, tp, r, split)
        piece = _cut(v, -2, lo, hi)
        out[k] = pack_int4_split(piece) if packed else piece
    return out


def _pad_cols(k: str, v, Np: int):
    """A vocabulary leaf padded to Np columns: zeros, unit scales."""
    if not isinstance(v, torch.Tensor) or v.ndim == 0:
        return v
    N = v.shape[-1]
    fill = 1.0 if k == "w_scale" else 0
    pad = torch.full((*v.shape[:-1], Np - N), fill, dtype=v.dtype,
                     device=v.device)
    return torch.cat([v, pad], dim=-1)


def shard_params(params: Dict, mesh: Mesh, specs: Optional[Dict] = None,
                 cfg=None) -> Dict:
    """This rank's local params tree: a pure function of (tree, tp index,
    tp), so a :func:`slice_mesh` serves without a process group. ``specs``
    default to :func:`vlm_param_specs` / :func:`decoder_param_specs`.
    ``cfg`` (the decoder's or a family's config) is checked by
    :func:`local_config` and gives the head width where KV heads replicate
    (tp > n_kv_heads) and the input widths that tell packed W4 rows; without
    it k / v are cut by columns as JAX cuts them. Replicated leaves are the
    input's tensors, not copies. Shard before ``prepare_w4_resident``: each
    rank packs and fuses its own tree."""
    vlm = "llm" in params
    specs = specs or (vlm_param_specs(params) if vlm
                      else decoder_param_specs(params))
    llm_cfg = None
    if cfg is not None:
        local_config(cfg, mesh)  # raises for a width tp does not divide
        llm_cfg = getattr(cfg, "llm", cfg)
    r, tp = mesh.tp_index, mesh.tp

    def walk(tree, spec, path):
        if tree is None or not isinstance(tree, dict):
            return tree
        if ("w" in tree or "w_q" in tree or "w_q_fused" in tree) and \
                isinstance(spec, dict):
            return _shard_site(tree, spec, path, r, tp, llm_cfg)
        return {k: walk(v, spec.get(k) if isinstance(spec, dict) else None,
                        f"{path}.{k}" if path else k)
                for k, v in tree.items()}

    if tp == 1:
        return params
    if not vlm:
        return walk(params, specs, "llm")
    prefix = {"vit": "vis"}  # the quant sites' names
    return {k: walk(v, specs.get(k), prefix.get(k, k))
            for k, v in params.items()}


def shard_batch(x: torch.Tensor, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """This dp rank's rows of a batch (``data_specs``' P("dp", None, ...)):
    the chunk dp_index of ``axis``."""
    n = _div(x.shape[axis], mesh.dp, "batch rows")
    return x.narrow(axis, mesh.dp_index * n, n)
