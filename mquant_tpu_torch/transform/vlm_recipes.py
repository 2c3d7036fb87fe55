"""Whole-VLM transform recipes, the Qwen2-VL, Qwen-VL, InternVL2 and GLM-4V
branches (counterpart of ``mquant_tpu/transform/vlm_recipes.py``): the ViT
tower's LayerScale fold, LN → RMSNorm fusion and rotation (a CLIP-style
tower's rotation entering through ``fc_sub_mean``'s output), the merger's
ln_q fold and mlp1's ln fold with their block-diagonal input rotations,
the resampler's norm folds and its cross-attention rotations Q_kv / Q_q /
Q_o, and :func:`prepare_vlm`, which runs them with the decoder's recipes
and rotates the LLM stream into the projector's last linear
(``merger.mlp2`` / ``res.proj_fc`` / ``proj.fc2`` / ``proj.4h_to_h``) and
GLM-4V's boi / eoi rows. GLM-4V's
EVA2CLIP tower is neither fused nor rotated: its stream feeds a conv, not a
LayerNorm, so centering it would change the function (the JAX package's
recipe, and the reference ships no GLM rotation).

LN exactness: every producer of a LayerNorm'd stream is mean-centered, so
LN ≡ affine · RMSNorm; the affine folds into the consumers and the norm
keeps a unit weight (its bias dropped: the forwards pick LN or RMSNorm by
the bias's presence). The ViT (a few GB in float64 at full size) is
transformed as one stacked float64 tree, as in the JAX package; the
decoder one layer at a time (``transform.recipes``). The float leaves
that stay float in an artifact and hold rows centered to a rounding
residue (a ViT's position table, the resampler's queries,
``fc_sub_mean``) are centered and rotated with numpy on the host, the JAX
recipe's own arithmetic, so the artifact's bytes are JAX's (the residue
otherwise rounds to other f32 bits). MiniCPM-V's branch is not ported
(ROADMAP A12c).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models.resampler import ResamplerConfig
from ..models.vision import MergerConfig, ViTConfig
from . import fuse as F
from . import hadamard as H
from . import rotate as R
from .recipes import _cast_like, _to_f64


def _drop_bias(norm: dict) -> dict:
    return {"w": torch.ones_like(norm["w"].to(torch.float64))}


def _np_rotate(w: torch.Tensor, Q: torch.Tensor,
               subscripts: str = "...io,oj->...ij") -> torch.Tensor:
    """w · Q in float64 by numpy's einsum on the host with the JAX recipe's
    subscripts (its ``rotate_linear_output``'s by default, "vh,hj->vj" for
    its ``rotate_embedding``), back on w's device."""
    out = np.einsum(subscripts, w.double().cpu().numpy(),
                    Q.double().cpu().numpy())
    return torch.from_numpy(out).to(w.device)


def fuse_vit(cfg: ViTConfig, params: Dict) -> Dict:
    """LN → RMSNorm fusion of a residual ViT tower (exact): fold LayerScale
    ls1 / ls2 into o / fc2 (left as unit weights), center the stream's
    producers (the patch embed and its position table, unless a CLIP
    tower's ln_pre and ``fc_sub_mean`` start the stream; o, fc2), fold ln1
    into q, k, v and ln2 into fc1. ln_pre stays a LayerNorm; ln_post is
    folded into the consumer by :func:`fold_ln_post_into`."""
    p = _to_f64(params)
    blocks = p["blocks"]
    if "ls1" in blocks:
        blocks["o"] = _fold_ls(blocks["o"], blocks["ls1"]["w"])
        blocks["fc2"] = _fold_ls(blocks["fc2"], blocks["ls2"]["w"])
        blocks["ls1"] = {"w": torch.ones_like(blocks["ls1"]["w"])}
        blocks["ls2"] = {"w": torch.ones_like(blocks["ls2"]["w"])}
    if not cfg.pre_norm:
        p["patch_embed"] = F.center_linear_output(p["patch_embed"])
        if "pos_embed" in p:
            p["pos_embed"] = {"w": F.center_embedding(p["pos_embed"]["w"])}
    blocks["o"] = F.center_linear_output(blocks["o"])
    blocks["fc2"] = F.center_linear_output(blocks["fc2"])
    _, _, qkv = F.fold_norm_into_linears(
        blocks["ln1"]["w"], blocks["ln1"].get("b"),
        [blocks["q"], blocks["k"], blocks["v"]])
    blocks["q"], blocks["k"], blocks["v"] = qkv
    blocks["ln1"] = _drop_bias(blocks["ln1"])
    _, _, fc1 = F.fold_norm_into_linears(
        blocks["ln2"]["w"], blocks["ln2"].get("b"), [blocks["fc1"]])
    blocks["fc1"] = fc1[0]
    blocks["ln2"] = _drop_bias(blocks["ln2"])
    return _cast_like(p, params)


def _fold_ls(linear: dict, g: torch.Tensor) -> dict:
    """A LayerScale gain g (L, out) folded into its producer's columns."""
    new = {**linear, "w": linear["w"] * g[..., None, :]}
    if linear.get("b") is not None:
        new["b"] = linear["b"] * g
    return new


def fold_ln_post_into(vit_params: Dict, consumers: list) -> tuple:
    """Fold the tower's ln_post affine into the linears that read the
    tower's output (the resampler's ``kv_proj``); ln_post is left a unit
    RMSNorm, exact on the centered stream. Returns (vit params, the new
    consumers)."""
    vp = _to_f64(vit_params)
    ln = vp["ln_post"]
    _, _, new = F.fold_norm_into_linears(ln["w"], ln.get("b"),
                                         [_to_f64(c) for c in consumers])
    vp["ln_post"] = _drop_bias(ln)
    return (_cast_like(vp, vit_params),
            [_cast_like(n, c) for n, c in zip(new, consumers)])


def rotate_vit(cfg: ViTConfig, params: Dict,
               gen: Optional[torch.Generator] = None,
               mode: str = "hadamard", rotate_ov: bool = True,
               Q: Optional[torch.Tensor] = None,
               online_had_fc2: bool = False) -> tuple:
    """Rotate the (fused) ViT residual stream by Q (drawn from ``gen``
    unless given). Returns (params, Q, fc2_pad): the stream's consumer (the
    merger, mlp1, the resampler's kv_proj) must be input-rotated by the
    same Q. A CLIP-style tower's stream starts at ln_pre's output, which no
    rotation passes: Q enters through ``fc_sub_mean``'s output, and the
    patch embed and its position table stay as they are.
    ``online_had_fc2`` pads the MLP width to a Hadamard-constructible size
    and folds the exact Hadamard into fc2's input."""
    p = _to_f64(params)
    blocks = p["blocks"]
    dev = blocks["q"]["w"].device
    if Q is None:
        Q = H.get_orthogonal_matrix(cfg.width, mode, gen, device=dev)
    Q = Q.to(device=dev, dtype=torch.float64)
    if cfg.pre_norm:
        if "fc_sub_mean" not in p:
            raise ValueError("rotating a pre_norm tower needs fc_sub_mean")
        p["fc_sub_mean"] = {**p["fc_sub_mean"], "w": _np_rotate(
            p["fc_sub_mean"]["w"], Q)}
    else:
        p["patch_embed"] = R.rotate_linear_output(p["patch_embed"], Q)
        if "pos_embed" in p:
            p["pos_embed"] = {"w": _np_rotate(p["pos_embed"]["w"], Q,
                                              "vh,hj->vj")}
    for s in ("q", "k", "v", "fc1"):
        blocks[s] = R.rotate_linear_input(blocks[s], Q)
    for s in ("o", "fc2"):
        blocks[s] = R.rotate_linear_output(blocks[s], Q)
    if rotate_ov:
        Qh = torch.from_numpy(H.transform_matrix(cfg.head_dim)).to(dev)
        blocks["v"], blocks["o"] = R.rotate_ov_per_head(
            blocks["v"], blocks["o"], cfg.head_dim, Qh)
    fc2_pad = 0
    if online_had_fc2:
        inter = blocks["fc2"]["w"].shape[-2]
        target = H.auto_pad_size(inter)
        if target != inter:
            # padded fc1 columns have zero weight and bias: act(0) = 0
            blocks["fc1"] = R.pad_linear_output(blocks["fc1"], target)
            blocks["fc2"] = R.pad_linear_input(blocks["fc2"], target)
            fc2_pad = target
        Hm = torch.from_numpy(H.transform_matrix(target)).to(dev)
        blocks["fc2"] = R.fold_exact_hadamard_input(blocks["fc2"], Hm)
    return _cast_like(p, params), Q, fc2_pad


def split_vit_fc2(params: Dict) -> Dict:
    """The RMS first-column split of every block's fc2 (pure slicing)."""
    p = dict(params)
    blocks = dict(p["blocks"])
    w = blocks["fc2"]["w"]
    blocks["fc2"] = {**blocks["fc2"], "w_col0": w[..., :1, :].contiguous(),
                     "w": w[..., 1:, :].contiguous()}
    p["blocks"] = blocks
    return p


def rotate_consumer_blockdiag(linear: dict, Q: torch.Tensor,
                              repeats: int) -> dict:
    """Input-rotate a consumer whose input is ``repeats`` concatenated
    stream vectors (the merger's mlp0, mlp1's fc1): fold kron(I_repeats,
    Qᵀ)."""
    w = linear["w"].to(torch.float64)
    *lead, fin, fout = w.shape
    n = Q.shape[0]
    if fin != repeats * n:
        raise ValueError(f"input dim {fin} != {repeats} x {n}")
    wr = torch.einsum("ij,...rjo->...rio", Q.to(torch.float64).T,
                      w.reshape(*lead, repeats, n, fout))
    return {**linear, "w": wr.reshape(*lead, fin, fout)}


def fuse_merger(cfg: MergerConfig, params: Dict) -> Dict:
    """Fold the merger's ln_q block-diagonally into mlp0 (exact once the
    ViT stream is centered)."""
    p = _to_f64(params)
    _, _, mlp0 = F.fold_norm_into_linears_blockdiag(
        p["ln_q"]["w"], p["ln_q"].get("b"), p["mlp0"],
        repeats=cfg.merge * cfg.merge)
    p["mlp0"] = mlp0
    p["ln_q"] = _drop_bias(p["ln_q"])
    return _cast_like(p, params)


def fuse_mlp1(params: Dict) -> Dict:
    """Fold mlp1's LayerNorm into fc1 as one norm over the whole
    concatenated input (its span: the downsample² pixel-shuffled stream
    vectors together). Exact only where that input is zero-mean, which
    centering each stream vector does not make it: approximate, as the JAX
    package's recipe."""
    p = _to_f64(params)
    _, _, fc1 = F.fold_norm_into_linears(p["ln"]["w"], p["ln"].get("b"),
                                         [p["fc1"]])
    p["fc1"] = fc1[0]
    p["ln"] = _drop_bias(p["ln"])
    return _cast_like(p, params)


def fuse_resampler(cfg: ResamplerConfig, params: Dict) -> Dict:
    """Fold the resampler's norms into their consumers: ln_kv into k and v
    (the key position table divided by ln_kv's γ), ln_q into q, ln_post
    into proj_fc; their producers (kv_proj, the queries, out) centered so
    that each LayerNorm is a unit RMSNorm."""
    p = _to_f64(params)
    if cfg.has_kv_proj and "kv_proj" in p:
        p["kv_proj"] = F.center_linear_output(p["kv_proj"])
    e = p["query"]["w"].cpu().numpy()
    p["query"] = {"w": torch.from_numpy(e - e.mean(axis=-1, keepdims=True))
                  .to(p["query"]["w"].device)}
    p["out"] = F.center_linear_output(p["out"])
    g_kv = p["ln_kv"]["w"]
    _, _, (p["k"], p["v"]) = F.fold_norm_into_linears(
        g_kv, p["ln_kv"].get("b"), [p["k"], p["v"]])
    if "pos_embed_kv" in p:
        # k reads ln_kv(x) + pos: with γ folded into k, pos is divided by γ
        p["pos_embed_kv"] = {"w": p["pos_embed_kv"]["w"] / g_kv}
    p["ln_kv"] = _drop_bias(p["ln_kv"])
    _, _, (p["q"],) = F.fold_norm_into_linears(
        p["ln_q"]["w"], p["ln_q"].get("b"), [p["q"]])
    p["ln_q"] = _drop_bias(p["ln_q"])
    if "proj_fc" in p:
        _, _, (p["proj_fc"],) = F.fold_norm_into_linears(
            p["ln_post"]["w"], p["ln_post"].get("b"), [p["proj_fc"]])
        p["ln_post"] = _drop_bias(p["ln_post"])
    return _cast_like(p, params)


def rotate_resampler(cfg: ResamplerConfig, params: Dict,
                     gen: Optional[torch.Generator] = None,
                     mode: str = "hadamard",
                     Q_vit: Optional[torch.Tensor] = None,
                     rotations: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict:
    """The cross-attention's own rotations, drawn from ``gen`` in the order
    Q_kv, Q_q, Q_o unless ``rotations`` gives them ("res_kv", "res_q",
    "res_o"): Q_vit (the tower's) into kv_proj's input; Q_kv on kv_proj's
    output, k's and v's inputs and the key position table; Q_q on the
    queries and q's input; Q_o on out's output and proj_fc's input."""
    rotations = rotations or {}
    p = _to_f64(params)
    dev = p["q"]["w"].device

    def draw(name):
        Q = rotations.get(name)
        if Q is None:
            Q = H.get_orthogonal_matrix(cfg.width, mode, gen, device=dev)
        return Q.to(device=dev, dtype=torch.float64)

    if Q_vit is not None and "kv_proj" in p:
        p["kv_proj"] = R.rotate_linear_input(p["kv_proj"], Q_vit.to(dev))
    Q = draw("res_kv")
    if "kv_proj" in p:
        p["kv_proj"] = R.rotate_linear_output(p["kv_proj"], Q)
        p["k"] = R.rotate_linear_input(p["k"], Q)
        p["v"] = R.rotate_linear_input(p["v"], Q)
        if "pos_embed_kv" in p:
            p["pos_embed_kv"] = {"w": R.rotate_embedding(
                p["pos_embed_kv"]["w"], Q)}
    Q = draw("res_q")
    p["query"] = {"w": _np_rotate(p["query"]["w"], Q, "vh,hj->vj")}
    p["q"] = R.rotate_linear_input(p["q"], Q)
    if "proj_fc" in p:
        Q = draw("res_o")
        p["out"] = R.rotate_linear_output(p["out"], Q)
        p["proj_fc"] = R.rotate_linear_input(p["proj_fc"], Q)
    return _cast_like(p, params)


# the projector site that writes the LLM stream, per family
_PRODUCER = {"qwen2vl": ("merger", "mlp2"), "qwenvl": ("res", "proj_fc"),
             "internvl": ("proj", "fc2"), "glm4v": ("proj", "4h_to_h")}


def prepare_vlm(family_name: str, cfg, params: Dict,
                gen: Optional[torch.Generator] = None, rotate: bool = True,
                rotate_visual: bool = True, rotate_llm: bool = True,
                mode: str = "hadamard", online_had_down: bool = True,
                online_had_mode: str = "full", split_down: bool = False,
                online_had_visual: bool = False, split_visual: bool = False,
                rotations: Optional[Dict[str, torch.Tensor]] = None
                ) -> tuple:
    """The offline equivalent transforms of a Qwen2-VL, Qwen-VL, InternVL2
    or GLM-4V model: fuse (LN → RMSNorm everywhere, LayerScale folded,
    Qwen-VL's ln_post into the resampler's kv_proj and the resampler's own
    norms; GLM-4V's decoder only) → rotate the vision stream (Q_v, into the
    merger's mlp0 / mlp1's fc1 block-diagonally, or the resampler's
    kv_proj; never GLM-4V's, whatever ``rotate_visual`` says), the
    resampler's cross-attention (Q_kv, Q_q, Q_o) and the LLM stream (Q_l,
    with the per-head OV rotation, the online Hadamard fold into ``down``,
    the projector's last linear's output and GLM-4V's boi / eoi rows) →
    the RMS split. The rotations are drawn from ``gen`` in that order
    unless ``rotations`` gives them as {"vit": Q_v, "res_kv": Q_kv,
    "res_q": Q_q, "res_o": Q_o, "llm": Q_l}. Returns (params, info)."""
    from .recipes import fuse_decoder, rotate_decoder, split_decoder_down

    if family_name not in _PRODUCER:
        raise NotImplementedError(f"{family_name}'s recipe branch is not "
                                  "ported (ROADMAP A12)")
    rotations = rotations or {}
    p = dict(params)
    info: Dict = {"family": family_name}
    # the towers' float64 work first, while one copy of the decoder is
    # resident (the fusions draw nothing: the order does not change them)
    if family_name == "glm4v":
        rotate_visual = False  # the tower stays as it is (module docstring)
    else:
        p["vit"] = fuse_vit(cfg.vit, p["vit"])
    if family_name == "qwen2vl":
        p["merger"] = fuse_merger(cfg.merger, p["merger"])
    elif family_name == "qwenvl":
        if cfg.vit.post_norm and "ln_post" in p["vit"]:
            p["vit"], (kvp,) = fold_ln_post_into(p["vit"],
                                                 [p["res"]["kv_proj"]])
            p["res"] = {**p["res"], "kv_proj": kvp}
        p["res"] = fuse_resampler(cfg.resampler, p["res"])
    elif family_name == "internvl":
        p["proj"] = fuse_mlp1(p["proj"])
    p["llm"] = fuse_decoder(cfg.llm, p["llm"])
    if not rotate:
        return p, info

    if rotate_visual:
        p["vit"], Q_v, fc2_pad = rotate_vit(
            cfg.vit, p["vit"], gen, mode, Q=rotations.get("vit"),
            online_had_fc2=online_had_visual)
        info["vit_rotated"] = True
        if online_had_visual:
            info["vis_online_had"] = True
            info["vis_fc2_pad"] = fc2_pad
        if split_visual:
            p["vit"] = split_vit_fc2(p["vit"])
            info["vis_split"] = True
        if family_name == "qwenvl":  # Q_v enters kv_proj's input
            p["res"] = rotate_resampler(cfg.resampler, p["res"], gen, mode,
                                        Q_vit=Q_v, rotations=rotations)
            info["resampler_rotated"] = True
        else:
            grp, site, repeats = (
                ("merger", "mlp0", cfg.merger.merge ** 2)
                if family_name == "qwen2vl"
                else ("proj", "fc1", cfg.mlp1.downsample ** 2))
            lin = rotate_consumer_blockdiag(p[grp][site], Q_v, repeats)
            p[grp] = {**p[grp], site: _cast_like(lin, params[grp][site])}

    if not rotate_llm:
        return p, info
    Q_l = rotations.get("llm")
    if Q_l is None:
        Q_l = H.get_orthogonal_matrix(cfg.llm.hidden, mode, gen,
                                      device=p["llm"]["embed"]["w"].device)
    p["llm"], info["llm"] = rotate_decoder(
        cfg.llm, p["llm"], mode=mode, online_had_down=online_had_down,
        online_had_mode=online_had_mode, Q=Q_l)
    grp, site = _PRODUCER[family_name]
    lin = R.rotate_linear_output(_to_f64(p[grp][site]),
                                 Q_l.to(p[grp][site]["w"].device))
    p[grp] = {**p[grp], site: _cast_like(lin, params[grp][site])}
    if family_name == "glm4v":
        # the boi / eoi rows live in the rotated stream: E Q_l, with
        # numpy's einsum on the host (the JAX recipe's own product)
        for t in ("boi", "eoi"):
            w = p["proj"][t]["w"]
            v = np.einsum("vh,hj->vj", w.double().cpu().numpy(),
                          Q_l.double().cpu().numpy())
            p["proj"] = {**p["proj"], t: {"w": torch.from_numpy(v).to(
                device=w.device, dtype=w.dtype)}}
    if split_down:
        p["llm"] = split_decoder_down(p["llm"])
        info["split"] = True
    return p, info
