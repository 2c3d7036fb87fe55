"""Decoder transform recipes: fuse → rotate → (pad + fold the online
Hadamard), RTN, the RMS split and integer realization (counterpart of
``mquant_tpu/transform/recipes.py``).

The math is float64, as in the JAX package, but one decoder layer at a
time on the weights' device (the JAX package converts the whole tree to a
float64 host copy, about 66 GB at Qwen2-VL-7B): each layer's slice is cast
to float64, transformed and cast back into new stacked tensors of the
original dtypes. Layers are independent, so the result is the same. Leaves
a transform does not touch are shared with the input tree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from ..models.llm import LLM_SITES, DecoderConfig
from . import fuse as F
from . import hadamard as H
from . import rotate as R


def _first_dtype(tree, default=torch.float32):
    if isinstance(tree, dict):
        for v in tree.values():
            d = _first_dtype(v, None)
            if d is not None:
                return d
        return default
    return tree.dtype if isinstance(tree, torch.Tensor) else default


def _to_f64(tree):
    if isinstance(tree, dict):
        return {k: _to_f64(v) for k, v in tree.items()}
    return tree.to(torch.float64) if isinstance(tree, torch.Tensor) else tree


def _cast_like(new, old, default=None):
    """Cast transformed float64 tensors back to the dtypes of their
    counterparts in ``old``; keys ``old`` lacks take the first dtype found
    in ``old`` (a transform may drop or add keys)."""
    default = default or _first_dtype(old)
    if isinstance(new, dict):
        old = old if isinstance(old, dict) else {}
        return {k: _cast_like(v, old.get(k), default) for k, v in new.items()}
    if not isinstance(new, torch.Tensor):
        return new
    dt = old.dtype if isinstance(old, torch.Tensor) else default
    return new.to(dt)


def map_layers(layers: Dict, sites: Sequence[str],
               fn: Callable[[Dict], Dict]) -> Dict:
    """Apply ``fn`` to each layer of a stacked (L, ...) layer tree, one
    layer at a time: ``fn`` gets {site: {leaf: float64 tensor}} of
    ``sites`` for one layer and returns the new float64 sites, which are
    cast back to the input's dtypes and stacked into new tensors (shapes
    may change, as a pad does); the other sites are shared."""
    n = next(v for v in layers[sites[0]].values()
             if isinstance(v, torch.Tensor)).shape[0]
    out: Dict = {}
    for li in range(n):
        lay = {s: {k: (v[li].to(torch.float64)
                       if isinstance(v, torch.Tensor) else v)
                   for k, v in layers[s].items()} for s in sites}
        new = _cast_like(fn(lay), {s: {k: (v[li] if isinstance(
            v, torch.Tensor) else v) for k, v in layers[s].items()}
            for s in sites})
        for s, site in new.items():
            dst = out.setdefault(s, {})
            for k, v in site.items():
                if not isinstance(v, torch.Tensor):
                    dst[k] = v
                    continue
                if li == 0:
                    dst[k] = torch.empty((n, *v.shape), dtype=v.dtype,
                                         device=v.device)
                dst[k][li].copy_(v)
    return {**layers, **out}


def _f64_chunks(w: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor],
                dim: int, chunk: int = 16384) -> torch.Tensor:
    """``fn`` of float64 slices of ``w`` along ``dim`` (``chunk`` at a
    time), cast back to w's dtype: the embedding and the head (152064 ×
    3584 at 7B, 4.4 GB in float64) without a whole float64 copy. ``fn``
    must treat the slices independently."""
    out = torch.empty_like(w)
    for lo in range(0, w.shape[dim], chunk):
        part = w.narrow(dim, lo, min(chunk, w.shape[dim] - lo))
        out.narrow(dim, lo, part.shape[dim]).copy_(fn(part.double()))
    return out


@dataclasses.dataclass
class RotationInfo:
    """What the offline transform did (written into the artifact's meta
    as the JAX package's repr)."""

    hidden_rotated: bool = False
    ov_rotated: bool = False
    online_had_down: bool = False
    online_had_mode: str = "full"
    down_pad: int = 0  # padded intermediate size (0 = unpadded)
    mode: str = "hadamard"
    seed: int = 0


# ---------------------------------------------------------------------------
# decoder fuse / rotate
# ---------------------------------------------------------------------------


def fuse_decoder(cfg: DecoderConfig, params: Dict) -> Dict:
    """Fold every norm's weight into its consumers (ln1 → q, k, v; ln2 →
    gate, up; ln_f → lm_head); the norms become unit RMSNorms. Exact for
    RMSNorm decoders. A tied embedding keeps ln_f."""

    def fuse(lay):
        g1, _, qkv = F.fold_norm_into_linears(
            lay["ln1"]["w"], None, [lay["q"], lay["k"], lay["v"]])
        g2, _, gu = F.fold_norm_into_linears(
            lay["ln2"]["w"], None, [lay["gate"], lay["up"]])
        return {"ln1": {**lay["ln1"], "w": g1}, "q": qkv[0], "k": qkv[1],
                "v": qkv[2], "ln2": {**lay["ln2"], "w": g2}, "gate": gu[0],
                "up": gu[1]}

    p = dict(params)
    p["layers"] = map_layers(params["layers"],
                             ("ln1", "q", "k", "v", "ln2", "gate", "up"), fuse)
    if "lm_head" in p:
        g = params["ln_f"]["w"].double()
        p["lm_head"] = {**params["lm_head"], "w": _f64_chunks(
            params["lm_head"]["w"], lambda w: w * g[:, None], dim=-1)}
        p["ln_f"] = {**params["ln_f"], "w": torch.ones_like(
            params["ln_f"]["w"])}
    return p


def assert_fused(params: Dict):
    ln = params["layers"]["ln1"]["w"].double()
    if not torch.allclose(ln, torch.ones_like(ln)):
        raise ValueError("rotate_decoder requires fuse_decoder to run first "
                         "(norm weights must be folded to 1)")


def rotate_decoder(cfg: DecoderConfig, params: Dict,
                   gen: Optional[torch.Generator] = None,
                   mode: str = "hadamard", rotate_ov: bool = True,
                   online_had_down: bool = False,
                   online_had_mode: str = "full",
                   Q: Optional[torch.Tensor] = None):
    """QuaRot-style rotation of the decoder's hidden stream by Q (drawn
    from ``gen`` unless given), the per-head V → O rotation and,
    optionally, the online Hadamard folded into ``down``: "full" over the
    intermediate padded to a Hadamard-constructible size, "block"
    (I ⊗ H₁₂₈) padded to a multiple of 128. Needs :func:`fuse_decoder`
    first. Returns (params, RotationInfo)."""
    assert_fused(params)
    dev = params["embed"]["w"].device
    info = RotationInfo(mode=mode)
    if Q is None:
        Q = H.get_orthogonal_matrix(cfg.hidden, mode, gen, device=dev)
    Q = Q.to(device=dev, dtype=torch.float64)
    info.hidden_rotated = True
    info.ov_rotated = rotate_ov
    Qh = torch.from_numpy(H.transform_matrix(cfg.head_dim)).to(dev)

    inter = params["layers"]["down"]["w"].shape[-2]
    target, Hd = inter, None
    if online_had_down:
        if online_had_mode == "block":
            target = -(-inter // 128) * 128
        else:
            target = H.auto_pad_size(inter)
            Hd = torch.from_numpy(H.transform_matrix(target)).to(dev)
        info.online_had_down = True
        info.online_had_mode = "block" if online_had_mode == "block" else \
            "full"
        info.down_pad = target if target != inter else 0

    def rotate(lay):
        for s in ("q", "k", "v", "gate", "up"):
            lay[s] = R.rotate_linear_input(lay[s], Q)
        for s in ("o", "down"):
            lay[s] = R.rotate_linear_output(lay[s], Q)
        if rotate_ov:
            lay["v"], lay["o"] = R.rotate_ov_per_head(
                lay["v"], lay["o"], cfg.head_dim, Qh,
                n_kv_heads=cfg.n_kv_heads, n_heads=cfg.n_heads)
        if online_had_down:
            if target != inter:
                lay["gate"] = R.pad_linear_output(lay["gate"], target)
                lay["up"] = R.pad_linear_output(lay["up"], target)
                lay["down"] = R.pad_linear_input(lay["down"], target)
            if Hd is None:
                lay["down"] = R.fold_exact_hadamard_input_block(lay["down"],
                                                                128)
            else:
                lay["down"] = R.fold_exact_hadamard_input(lay["down"], Hd)
        return lay

    p = dict(params)
    p["layers"] = map_layers(params["layers"], tuple(LLM_SITES), rotate)
    p["embed"] = {**params["embed"], "w": _f64_chunks(
        params["embed"]["w"], lambda e: R.rotate_embedding(e, Q), dim=0)}
    if "lm_head" in p:
        p["lm_head"] = {**params["lm_head"], "w": _f64_chunks(
            params["lm_head"]["w"], lambda w: Q.T @ w, dim=-1)}
    return p, info


def split_decoder_down(params: Dict) -> Dict:
    """The RMS first-column split of every layer's ``down``: ``w_col0``
    (L, 1, out) stays float, ``w`` keeps rows 1.. (pure slicing)."""
    p = dict(params)
    lay = dict(p["layers"])
    w = lay["down"]["w"]
    lay["down"] = {**lay["down"], "w_col0": w[..., :1, :].contiguous(),
                   "w": w[..., 1:, :].contiguous()}
    p["layers"] = lay
    return p


# ---------------------------------------------------------------------------
# RTN and integer realization
# ---------------------------------------------------------------------------


def rtn_quantize_decoder(cfg: DecoderConfig, params: Dict, specs: Dict,
                         mse_clip: bool = False, symmetric: bool = True,
                         return_qparams: bool = False):
    """Round-to-nearest fake quantization of every spec'd decoder site,
    per layer and output channel (the split's ``w_col0`` stays float).
    ``return_qparams`` → (params, {site: (scale (L, 1, out), zero or
    None)}), the exact grids for :func:`realize_decoder_weights`."""
    from ..core import quant as Q
    from ..core.formats import get_format

    p = dict(params)
    lay = dict(p["layers"])
    qps: Dict = {}

    def fq(w, bits, reduce_axes):
        fmt = get_format(bits, signed=symmetric)
        qp = Q.weight_qparams(w, fmt, per_channel=True, symmetric=symmetric,
                              mse_clip=mse_clip, reduce_axes=reduce_axes)
        return Q.fake_quantize(w, qp, fmt), qp

    for s in LLM_SITES:
        spec = specs.get("llm." + s)
        if spec is None or spec.w_bits is None:
            continue
        site = dict(lay[s])
        site["w"], qp = fq(site["w"], spec.w_bits, (-2,))
        lay[s] = site
        n, _, out = site["w"].shape
        qps[s] = (qp.scale.reshape(n, 1, out),
                  None if qp.zero_point is None
                  else qp.zero_point.reshape(n, 1, out))
    p["layers"] = lay
    head_spec = specs.get("llm.lm_head")
    if head_spec is not None and head_spec.w_bits is not None \
            and "lm_head" in p:
        head = dict(p["lm_head"])
        head["w"], qp = fq(head["w"], head_spec.w_bits, None)
        p["lm_head"] = head
        out = head["w"].shape[-1]
        qps["lm_head"] = (qp.scale.reshape(1, out),
                          None if qp.zero_point is None
                          else qp.zero_point.reshape(1, out))
    return (p, qps) if return_qparams else p


def _refuse_storage(site: str, zero, groups: int, perm, fold: bool):
    what = [w for w, on in (("asymmetric", zero is not None),
                            ("grouped", groups > 1),
                            ("act_order-permuted", perm is not None),
                            ("per-channel static activation (a_fold)", fold))
            if on]
    if what:
        raise NotImplementedError(
            f"llm.{site}: {' and '.join(what)} integer storage is not ported "
            "(ROADMAP A4)")


def realize_decoder_weights(params: Dict, specs: Dict,
                            pack_int4: bool = False,
                            qps: Optional[Dict] = None,
                            state: Optional[Dict] = None) -> Dict:
    """Spec'd decoder sites (and a quantized lm_head) → integer storage
    ``w_q`` / ``w_scale``, one layer at a time with
    ``kernels.qmm.quantize_weights_real``. ``qps`` holds the exact grids
    the fake-quantized weights lie on (GPTQ's or RTN's), so the codes are
    recovered losslessly; without them a per-channel symmetric grid is
    derived. W4 codes stay one per int8 byte unless ``pack_int4``. The
    grouped, asymmetric, act_order-permuted and per-channel-activation
    (``a_fold``) storage raise (ROADMAP A4), as the serving side does."""
    from ..kernels.qmm import quantize_weights_real

    p = dict(params)
    lay = dict(p["layers"])
    for s in LLM_SITES:
        spec = specs.get("llm." + s)
        if spec is None or spec.w_bits is None:
            continue
        site = dict(lay[s])
        w = site.pop("w")
        sqp = (qps or {}).get(s)
        aqp = ((state or {}).get("llm." + s) or {}).get("act")
        fold = (spec.a_bits is not None and spec.a_static and aqp is not None
                and aqp.scale.ndim >= 1 and aqp.scale.shape[-1] == w.shape[-2])
        scale = zero = perm = None
        if sqp is not None:
            scale, zero = sqp[0], sqp[1]
            perm = sqp[2] if len(sqp) > 2 else None
        _refuse_storage(s, zero, 1 if scale is None else scale.shape[-2],
                        perm, fold)
        out: Dict = {}
        for li in range(w.shape[0]):
            qd = quantize_weights_real(
                w[li], spec.w_bits, pack=pack_int4,
                scale=None if scale is None else scale[li])
            for k, v in qd.items():
                if li == 0:
                    out[k] = torch.empty((w.shape[0], *v.shape),
                                         dtype=v.dtype, device=v.device)
                out[k][li].copy_(v)
        site.update(out)
        lay[s] = site
    p["layers"] = lay
    head_qp = (qps or {}).get("lm_head")
    head_spec = specs.get("llm.lm_head")
    if (head_spec is not None and head_spec.w_bits is not None
            and head_qp is not None and "w" in p.get("lm_head", {})):
        _refuse_storage("lm_head", head_qp[1], head_qp[0].shape[0], None,
                        False)
        head = dict(p["lm_head"])
        head.update(quantize_weights_real(head.pop("w"), head_spec.w_bits,
                                          pack=False, scale=head_qp[0]))
        p["lm_head"] = head
    return p
