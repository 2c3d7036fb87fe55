"""HF checkpoint loading for Qwen2-VL, Qwen-VL, InternVL2 and GLM-4V
(counterpart of ``mquant_tpu/models/loader.py``): safetensors (sharded
with an index, or one file) or ``pytorch_model.bin`` → the port's stacked
parameter tree, with the JAX loader's weight surgery at load time.

HF linears store (out, in); the tree stores (in, out), so weights are
transposed. Surgery (the JAX loader's, exactly): the three LLM prefixes
(``model.language_model.``, ``model.``, ``language_model.model.``) and the
two visual ones (``model.visual.``, ``visual.``); the visual fused
``attn.qkv`` split into contiguous thirds; the conv3d patch embed (out, C,
T, ph, pw) permuted to (ph, pw, T, C, out), the patchify order, and
flattened; a tied head (no ``lm_head.weight``) untied as ``embed.T``.
InternVL2 (:func:`load_internvl`): InternLM2's ``wqkv``, interleaved by GQA
group as (KV, G + 2, hd, hidden), split into contiguous q / k / v; the
vision ``attn.qkv`` split into thirds; the conv patch embed (out, C, ph,
pw) permuted to :func:`~mquant_tpu_torch.models.vision.patchify_2d`'s
(ph, pw, C) order and flattened; the cls row of the position table
dropped; ``mlp1`` = [LayerNorm, fc1, GELU, fc2]. GLM-4V
(:func:`load_glm4v`): ChatGLM's fused MQA ``query_key_value`` split into
[q | k | v] (weights and biases), ``dense_h_to_4h`` into [gate | up]; the
EVA2CLIP blocks' fused qkv into thirds; the patch conv and the projector's
2 × 2 ``conv`` permuted to the merge order (kh, kw, C) and flattened; the
cls row of the position table dropped; boi / eoi (1, 1, hidden) as (1,
hidden) rows.

Safetensors shards are read with the port's own reader
(:mod:`mquant_tpu_torch.utils.safetensors`), a tensor at a time from a
mapping of the file. Each leaf is cast to ``dtype`` as it is written into
its stacked tensor on ``device`` (f32, the JAX loader's host dtype, when
``dtype`` is None), so no float32 copy of the whole model is ever made.
Qwen-VL-Chat (:func:`load_qwenvl`): Qwen's fused ``c_attn`` split into
thirds, its MLP's ``w2`` / ``w1`` as gate / up; the visual ``in_proj``
de-interleaved per head into q / k / v; the conv patch embed (no bias) as
a linear; ``attn_pool``'s ``in_proj`` into thirds, the matrix ``proj`` as
``res.proj_fc`` with a zero bias, the visual ln_post (output_dim wide,
after the pool) as the resampler's ``ln_post``, and the exact
``fc_sub_mean``. The tower gets no ``ln_post``: HF's tower has no norm
after its blocks, and the JAX loader's copy of the pool's norm there does
not fit the tower's width (ROADMAP C-w25). MiniCPM-V's loader is not
ported (ROADMAP A12c).
:func:`save_qwen2vl_hf` is the inverse: a tree in the port's layout
written as a sharded HF checkpoint (HF names, the fused ``attn.qkv``, the
conv3d patch embed) with the port's writer.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import torch

from ..utils import safetensors as st


class TensorStore:
    """Lazy name → tensor access over sharded / single safetensors or a
    torch ``pytorch_model.bin``."""

    def __init__(self, model_dir: str):
        self.dir = model_dir
        self._maps: Dict[str, str] = {}
        self._files: Dict[str, st.SafeOpen] = {}
        idx = os.path.join(model_dir, "model.safetensors.index.json")
        if os.path.exists(idx):
            with open(idx) as f:
                self._maps = json.load(f)["weight_map"]
            self._mode = "sharded"
        elif os.path.exists(os.path.join(model_dir, "model.safetensors")):
            self._mode = "single"
        elif os.path.exists(os.path.join(model_dir, "pytorch_model.bin")):
            self._mode = "torch"
            self._torch_state = torch.load(
                os.path.join(model_dir, "pytorch_model.bin"),
                map_location="cpu", weights_only=True)
        else:
            raise FileNotFoundError(f"no checkpoint found in {model_dir}")

    def _file_for(self, name: str) -> st.SafeOpen:
        fn = (self._maps.get(name, "model.safetensors")
              if self._mode == "sharded" else "model.safetensors")
        if fn not in self._files:
            self._files[fn] = st.SafeOpen(os.path.join(self.dir, fn))
        return self._files[fn]

    def __contains__(self, name: str) -> bool:
        if self._mode == "torch":
            return name in self._torch_state
        if self._mode == "sharded":
            return name in self._maps
        return name in self._file_for(name)

    def get(self, name: str) -> torch.Tensor:
        """The host tensor in its stored dtype (a view of the file's
        mapping for safetensors)."""
        if self._mode == "torch":
            return self._torch_state[name]
        return self._file_for(name).get_tensor(name, copy=False)

    def lin(self, prefix: str, bias: bool = True) -> dict:
        """HF Linear (out, in) + (out,) → {"w": (in, out), "b": ...}."""
        w = self.get(prefix + ".weight").T
        b = (self.get(prefix + ".bias")
             if bias and (prefix + ".bias") in self else None)
        return {"w": w, "b": b}

    def norm(self, prefix: str) -> dict:
        d = {"w": self.get(prefix + ".weight")}
        if (prefix + ".bias") in self:
            d["b"] = self.get(prefix + ".bias")
        return d

    def close(self):
        self._files.clear()


def _put(dst: torch.Tensor, v: torch.Tensor):
    """dst.copy_(v); a transposed host view crosses to the card as its
    contiguous original and is transposed there."""
    if (v.device != dst.device and v.ndim == 2 and not v.is_contiguous()
            and v.T.is_contiguous()):
        v = v.T.to(dst.device).T
    dst.copy_(v)


def _leaf(t: Optional[torch.Tensor], dtype, device):
    if t is None:
        return None
    out = torch.empty(t.shape, dtype=dtype, device=device)
    _put(out, t)
    return out


def _stack(dicts: List[dict], dtype, device) -> dict:
    """Per-layer nested dicts of host tensors → layer-stacked tensors on
    ``device`` in ``dtype`` (None preserved), written a layer at a time."""
    out = {}
    for k in dicts[0]:
        vals = [d[k] for d in dicts]
        if isinstance(vals[0], dict):
            out[k] = _stack(vals, dtype, device)
        elif vals[0] is None:
            out[k] = None
        else:
            t = torch.empty((len(vals), *vals[0].shape), dtype=dtype,
                            device=device)
            for i, v in enumerate(vals):
                _put(t[i], v)
            out[k] = t
    return out


def _split_cols(w_t: torch.Tensor, sizes: List[int]) -> List[torch.Tensor]:
    """Split a fused HF (out, in) weight along out into consecutive groups,
    returned in the (in, out_i) layout."""
    outs, o = [], 0
    for s in sizes:
        outs.append(w_t[o:o + s].T)
        o += s
    return outs


def load_qwen2vl(cfg, model_dir: str, dtype=torch.float32,
                 device="cuda") -> Dict:
    """HF Qwen2-VL → params on ``device`` in ``dtype``."""
    ts = TensorStore(model_dir)
    lcfg, vcfg = cfg.llm, cfg.vit
    leaf = lambda t: _leaf(t, dtype, device)  # noqa: E731

    if "model.language_model.embed_tokens.weight" in ts:
        pref = "model.language_model."
    elif "model.embed_tokens.weight" in ts:
        pref = "model."
    else:
        pref = "language_model.model."
    layers = []
    for i in range(lcfg.n_layers):
        b = f"{pref}layers.{i}."
        layers.append({
            "ln1": ts.norm(b + "input_layernorm"),
            "q": ts.lin(b + "self_attn.q_proj"),
            "k": ts.lin(b + "self_attn.k_proj"),
            "v": ts.lin(b + "self_attn.v_proj"),
            "o": ts.lin(b + "self_attn.o_proj"),
            "ln2": ts.norm(b + "post_attention_layernorm"),
            "gate": ts.lin(b + "mlp.gate_proj"),
            "up": ts.lin(b + "mlp.up_proj"),
            "down": ts.lin(b + "mlp.down_proj"),
        })
    embed = leaf(ts.get(pref + "embed_tokens.weight"))
    llm = {"embed": {"w": embed},
           "layers": _stack(layers, dtype, device),
           "ln_f": {k: leaf(v) for k, v in ts.norm(pref + "norm").items()}}
    del layers
    # untie before fusion / rotation, as the reference does for 2B
    llm["lm_head"] = ({"w": leaf(ts.get("lm_head.weight").T), "b": None}
                      if "lm_head.weight" in ts
                      else {"w": embed.T.contiguous(), "b": None})

    vp = ("model.visual." if "model.visual.patch_embed.proj.weight" in ts
          else "visual.")
    conv = ts.get(vp + "patch_embed.proj.weight")  # (out, C, T, ph, pw)
    out_c = conv.shape[0]
    # the flatten order of patchify_qwen2vl: (ph, pw, t, c)
    w_pe = conv.permute(3, 4, 2, 1, 0).reshape(-1, out_c)
    blocks = []
    for i in range(vcfg.n_layers):
        b = f"{vp}blocks.{i}."
        qw, kw, vw = _split_cols(ts.get(b + "attn.qkv.weight"),
                                 [vcfg.width] * 3)
        qb = kb = vb = None
        if (b + "attn.qkv.bias") in ts:
            qb, kb, vb = torch.chunk(ts.get(b + "attn.qkv.bias"), 3)
        blocks.append({
            "ln1": ts.norm(b + "norm1"),
            "q": {"w": qw, "b": qb},
            "k": {"w": kw, "b": kb},
            "v": {"w": vw, "b": vb},
            "o": ts.lin(b + "attn.proj"),
            "ln2": ts.norm(b + "norm2"),
            "fc1": ts.lin(b + "mlp.fc1"),
            "fc2": ts.lin(b + "mlp.fc2"),
        })
    vit = {"patch_embed": {"w": leaf(w_pe), "b": None},
           "blocks": _stack(blocks, dtype, device)}
    del blocks

    def lin(name):
        return {k: leaf(v) for k, v in ts.lin(vp + name).items()}

    merger = {"ln_q": {k: leaf(v)
                       for k, v in ts.norm(vp + "merger.ln_q").items()},
              "mlp0": lin("merger.mlp.0"), "mlp2": lin("merger.mlp.2")}
    ts.close()
    return {"llm": llm, "vit": vit, "merger": merger}


def qwen2vl_hf_tensors(cfg, params: Dict):
    """(HF name, bytes, make) for each tensor of a Qwen2-VL tree in the
    port's layout, the loader's surgery undone: ``make()`` gives the tensor
    on the tree's device (weights (out, in) contiguous; the current
    transformers names)."""
    llm, vit, mg = params["llm"], params["vit"], params["merger"]
    pref, vp = "model.language_model.", "model.visual."

    def out(name, fn, *srcs):
        return name, sum(t.numel() * t.element_size() for t in srcs), fn

    def lin(name, site, li=None):
        w = site["w"] if li is None else site["w"][li]
        yield out(name + ".weight", lambda: w.T.contiguous(), w)
        b = site.get("b")
        if b is not None:
            b = b if li is None else b[li]
            yield out(name + ".bias", lambda: b, b)

    def norm(name, site, li=None):
        for k, suffix in (("w", ".weight"), ("b", ".bias")):
            v = site.get(k)
            if v is not None:
                v = v if li is None else v[li]
                yield out(name + suffix, lambda v=v: v, v)

    emb = llm["embed"]["w"]
    yield out(pref + "embed_tokens.weight", lambda: emb, emb)
    lay = llm["layers"]
    for i in range(cfg.llm.n_layers):
        b = f"{pref}layers.{i}."
        yield from norm(b + "input_layernorm", lay["ln1"], i)
        for hf, site in (("self_attn.q_proj", "q"), ("self_attn.k_proj", "k"),
                         ("self_attn.v_proj", "v"), ("self_attn.o_proj", "o"),
                         ("mlp.gate_proj", "gate"), ("mlp.up_proj", "up"),
                         ("mlp.down_proj", "down")):
            yield from lin(b + hf, lay[site], i)
        yield from norm(b + "post_attention_layernorm", lay["ln2"], i)
    yield from norm(pref + "norm", llm["ln_f"])
    head = llm["lm_head"]["w"]
    yield out("lm_head.weight", lambda: head.T.contiguous(), head)

    pe = vit["patch_embed"]["w"]  # (ph·pw·T·C, out), patchify order
    p, C = cfg.patch, 3
    T = pe.shape[0] // (p * p * C)
    yield out(vp + "patch_embed.proj.weight", lambda: pe.reshape(
        p, p, T, C, -1).permute(4, 3, 2, 0, 1).contiguous(), pe)
    blk = vit["blocks"]
    for i in range(cfg.vit.n_layers):
        b = f"{vp}blocks.{i}."
        qkv = [blk[s]["w"][i] for s in ("q", "k", "v")]
        yield from norm(b + "norm1", blk["ln1"], i)
        yield out(b + "attn.qkv.weight",
                  lambda qkv=qkv: torch.cat([w.T for w in qkv]).contiguous(),
                  *qkv)
        if blk["q"].get("b") is not None:
            qkvb = [blk[s]["b"][i] for s in ("q", "k", "v")]
            yield out(b + "attn.qkv.bias", lambda qkvb=qkvb: torch.cat(qkvb),
                      *qkvb)
        yield from lin(b + "attn.proj", blk["o"], i)
        yield from norm(b + "norm2", blk["ln2"], i)
        yield from lin(b + "mlp.fc1", blk["fc1"], i)
        yield from lin(b + "mlp.fc2", blk["fc2"], i)
    yield from norm(vp + "merger.ln_q", mg["ln_q"])
    yield from lin(vp + "merger.mlp.0", mg["mlp0"])
    yield from lin(vp + "merger.mlp.2", mg["mlp2"])


def save_qwen2vl_hf(cfg, params: Dict, out_dir: str,
                    max_shard_bytes: int = 5 * 2**30) -> int:
    """Write a Qwen2-VL tree (the port's layout, any device) as a sharded HF
    checkpoint: ``model-0000i-of-0000n.safetensors`` shards of at most
    ``max_shard_bytes`` of tensors (a larger tensor gets a shard of its
    own) and ``model.safetensors.index.json``. A shard's tensors are made
    only as it is written. Returns the bytes of the shard files."""
    os.makedirs(out_dir, exist_ok=True)
    plan, cur, size, total = [], [], 0, 0
    for entry in qwen2vl_hf_tensors(cfg, params):
        if cur and size + entry[1] > max_shard_bytes:
            plan.append(cur)
            cur, size = [], 0
        cur.append(entry)
        size += entry[1]
        total += entry[1]
    plan.append(cur)
    weight_map, written = {}, 0
    for i, shard in enumerate(plan):
        fn = f"model-{i + 1:05d}-of-{len(plan):05d}.safetensors"
        written += st.save_file({name: make() for name, _, make in shard},
                                os.path.join(out_dir, fn),
                                metadata={"format": "pt"})
        weight_map.update({name: fn for name, _, _ in shard})
    with open(os.path.join(out_dir, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    return written


def _conv_linear(conv: torch.Tensor) -> torch.Tensor:
    """A conv kernel (out, C, kh, kw) whose stride is its size as the
    linear (kh · kw · C, out) over patches merged in (kh, kw, C) order."""
    return conv.permute(2, 3, 1, 0).reshape(-1, conv.shape[0])


def load_internvl(cfg, model_dir: str, dtype=torch.float32,
                  device="cuda") -> Dict:
    """HF InternVL2 (InternViT + InternLM2) → params on ``device`` in
    ``dtype``."""
    ts = TensorStore(model_dir)
    lcfg, vcfg = cfg.llm, cfg.vit
    H, KV, hd, Hd = (lcfg.n_heads, lcfg.n_kv_heads, lcfg.head_dim,
                     lcfg.hidden)
    G = H // KV  # queries per kv group
    leaf = lambda t: _leaf(t, dtype, device)  # noqa: E731

    layers = []
    for i in range(lcfg.n_layers):
        b = f"language_model.model.layers.{i}."
        w3 = ts.get(b + "attention.wqkv.weight").reshape(KV, G + 2, hd, Hd)
        layers.append({
            "ln1": ts.norm(b + "attention_norm"),
            "q": {"w": w3[:, :G].reshape(H * hd, Hd).T, "b": None},
            "k": {"w": w3[:, G].reshape(KV * hd, Hd).T, "b": None},
            "v": {"w": w3[:, G + 1].reshape(KV * hd, Hd).T, "b": None},
            "o": {"w": ts.get(b + "attention.wo.weight").T, "b": None},
            "ln2": ts.norm(b + "ffn_norm"),
            "gate": {"w": ts.get(b + "feed_forward.w1.weight").T, "b": None},
            "up": {"w": ts.get(b + "feed_forward.w3.weight").T, "b": None},
            "down": {"w": ts.get(b + "feed_forward.w2.weight").T, "b": None},
        })
    llm = {"embed": {"w": leaf(ts.get(
               "language_model.model.tok_embeddings.weight"))},
           "layers": _stack(layers, dtype, device),
           "ln_f": {k: leaf(v) for k, v in ts.norm(
               "language_model.model.norm").items()},
           "lm_head": {"w": leaf(ts.get("language_model.output.weight").T),
                       "b": None}}
    del layers

    vp = "vision_model."
    blocks = []
    for i in range(vcfg.n_layers):
        b = f"{vp}encoder.layers.{i}."
        qw, kw, vw = _split_cols(ts.get(b + "attn.qkv.weight"),
                                 [vcfg.width] * 3)
        qb, kb, vb = torch.chunk(ts.get(b + "attn.qkv.bias"), 3)
        blocks.append({
            "ln1": ts.norm(b + "norm1"),
            "q": {"w": qw, "b": qb}, "k": {"w": kw, "b": kb},
            "v": {"w": vw, "b": vb},
            "o": ts.lin(b + "attn.proj"),
            "ls1": {"w": ts.get(b + "ls1")},
            "ln2": ts.norm(b + "norm2"),
            "fc1": ts.lin(b + "mlp.fc1"),
            "fc2": ts.lin(b + "mlp.fc2"),
            "ls2": {"w": ts.get(b + "ls2")},
        })
    vit = {"patch_embed": {
               "w": leaf(_conv_linear(ts.get(
                   vp + "embeddings.patch_embedding.weight"))),
               "b": leaf(ts.get(vp + "embeddings.patch_embedding.bias"))},
           "pos_embed": {"w": leaf(ts.get(
               vp + "embeddings.position_embedding")[0, 1:])},
           "blocks": _stack(blocks, dtype, device)}
    del blocks

    def lin(name):
        return {k: leaf(v) for k, v in ts.lin(name).items()}

    proj = {"ln": {k: leaf(v) for k, v in ts.norm("mlp1.0").items()},
            "fc1": lin("mlp1.1"), "fc2": lin("mlp1.3")}
    ts.close()
    return {"llm": llm, "vit": vit, "proj": proj}


def load_glm4v(cfg, model_dir: str, dtype=torch.float32,
               device="cuda") -> Dict:
    """HF GLM-4V (EVA2CLIP + GLU projector + ChatGLM) → params on
    ``device`` in ``dtype``."""
    ts = TensorStore(model_dir)
    lcfg, vcfg = cfg.llm, cfg.vit
    H, KV, hd = lcfg.n_heads, lcfg.n_kv_heads, lcfg.head_dim
    leaf = lambda t: _leaf(t, dtype, device)  # noqa: E731

    layers = []
    for i in range(lcfg.n_layers):
        b = f"transformer.encoder.layers.{i}."
        sizes = [H * hd, KV * hd, KV * hd]
        qw, kw, vw = _split_cols(
            ts.get(b + "self_attention.query_key_value.weight"), sizes)
        qb, kb, vb = torch.split(
            ts.get(b + "self_attention.query_key_value.bias"), sizes)
        gw, uw = _split_cols(ts.get(b + "mlp.dense_h_to_4h.weight"),
                             [lcfg.intermediate] * 2)
        layers.append({
            "ln1": ts.norm(b + "input_layernorm"),
            "q": {"w": qw, "b": qb}, "k": {"w": kw, "b": kb},
            "v": {"w": vw, "b": vb},
            "o": {"w": ts.get(b + "self_attention.dense.weight").T,
                  "b": None},
            "ln2": ts.norm(b + "post_attention_layernorm"),
            "gate": {"w": gw, "b": None},
            "up": {"w": uw, "b": None},
            "down": {"w": ts.get(b + "mlp.dense_4h_to_h.weight").T,
                     "b": None},
        })
    llm = {"embed": {"w": leaf(ts.get(
               "transformer.embedding.word_embeddings.weight"))},
           "layers": _stack(layers, dtype, device),
           "ln_f": {k: leaf(v) for k, v in ts.norm(
               "transformer.encoder.final_layernorm").items()},
           "lm_head": {"w": leaf(ts.get("transformer.output_layer.weight").T),
                       "b": None}}
    del layers

    vp = "transformer.vision."
    blocks = []
    for i in range(vcfg.n_layers):
        b = f"{vp}transformer.layers.{i}."
        qw, kw, vw = _split_cols(
            ts.get(b + "attention.query_key_value.weight"), [vcfg.width] * 3)
        qb, kb, vb = torch.chunk(
            ts.get(b + "attention.query_key_value.bias"), 3)
        blocks.append({
            "ln1": ts.norm(b + "input_layernorm"),
            "q": {"w": qw, "b": qb}, "k": {"w": kw, "b": kb},
            "v": {"w": vw, "b": vb},
            "o": ts.lin(b + "attention.dense"),
            "ln2": ts.norm(b + "post_attention_layernorm"),
            "fc1": ts.lin(b + "mlp.fc1"),
            "fc2": ts.lin(b + "mlp.fc2"),
        })
    vit = {"patch_embed": {
               "w": leaf(_conv_linear(ts.get(
                   vp + "patch_embedding.proj.weight"))),
               "b": leaf(ts.get(vp + "patch_embedding.proj.bias"))},
           "pos_embed": {"w": leaf(ts.get(
               vp + "patch_embedding.position_embedding.weight")[1:])},
           "blocks": _stack(blocks, dtype, device)}
    del blocks

    def t_(name):
        return leaf(ts.get(vp + name + ".weight").T)

    proj = {"conv": {"w": leaf(_conv_linear(ts.get(vp + "conv.weight"))),
                     "b": leaf(ts.get(vp + "conv.bias"))},
            "linear_proj": {"w": t_("linear_proj.linear_proj"), "b": None},
            "norm1": {k: leaf(v) for k, v in ts.norm(
                vp + "linear_proj.norm1").items()},
            "gate": {"w": t_("linear_proj.gate_proj"), "b": None},
            "h_to_4h": {"w": t_("linear_proj.dense_h_to_4h"), "b": None},
            "4h_to_h": {"w": t_("linear_proj.dense_4h_to_h"), "b": None},
            "boi": {"w": leaf(ts.get(vp + "boi")[0])},
            "eoi": {"w": leaf(ts.get(vp + "eoi")[0])}}
    ts.close()
    return {"llm": llm, "vit": vit, "proj": proj}


def load_qwenvl(cfg, model_dir: str, dtype=torch.float32,
                device="cuda") -> Dict:
    """HF Qwen-VL-Chat → params on ``device`` in ``dtype``."""
    from ..transform.fuse import sub_mean_matrix

    ts = TensorStore(model_dir)
    lcfg, vcfg, rcfg = cfg.llm, cfg.vit, cfg.resampler
    leaf = lambda t: _leaf(t, dtype, device)  # noqa: E731

    layers = []
    for i in range(lcfg.n_layers):
        b = f"transformer.h.{i}."
        qw, kw, vw = _split_cols(ts.get(b + "attn.c_attn.weight"),
                                 [lcfg.hidden] * 3)
        qb, kb, vb = torch.chunk(ts.get(b + "attn.c_attn.bias"), 3)
        layers.append({
            "ln1": ts.norm(b + "ln_1"),
            "q": {"w": qw, "b": qb}, "k": {"w": kw, "b": kb},
            "v": {"w": vw, "b": vb},
            "o": {"w": ts.get(b + "attn.c_proj.weight").T, "b": None},
            "ln2": ts.norm(b + "ln_2"),
            # Qwen's MLP: c_proj(w1(x) · silu(w2(x))): gate = w2, up = w1
            "gate": {"w": ts.get(b + "mlp.w2.weight").T, "b": None},
            "up": {"w": ts.get(b + "mlp.w1.weight").T, "b": None},
            "down": {"w": ts.get(b + "mlp.c_proj.weight").T, "b": None},
        })
    llm = {"embed": {"w": leaf(ts.get("transformer.wte.weight"))},
           "layers": _stack(layers, dtype, device),
           "ln_f": {k: leaf(v) for k, v in ts.norm(
               "transformer.ln_f").items()},
           "lm_head": {"w": leaf(ts.get("lm_head.weight").T), "b": None}}
    del layers

    vp = "transformer.visual."
    W, H = vcfg.width, vcfg.n_heads
    hd = W // H
    blocks = []
    for i in range(vcfg.n_layers):
        b = f"{vp}transformer.resblocks.{i}."
        # in_proj interleaved per head, [q_h0, k_h0, v_h0, q_h1, …] →
        # contiguous q, k, v
        w3 = ts.get(b + "attn.in_proj.weight").reshape(H, 3, hd, W)
        b3 = ts.get(b + "attn.in_proj.bias").reshape(H, 3, hd)
        blocks.append({
            "ln1": ts.norm(b + "ln_1"),
            **{s: {"w": w3[:, j].reshape(W, W).T, "b": b3[:, j].reshape(-1)}
               for j, s in enumerate("qkv")},
            "o": ts.lin(b + "attn.out_proj"),
            "ln2": ts.norm(b + "ln_2"),
            "fc1": ts.lin(b + "mlp.c_fc"),
            "fc2": ts.lin(b + "mlp.c_proj"),
        })

    def norm(name):
        return {k: leaf(v) for k, v in ts.norm(name).items()}

    vit = {"patch_embed": {"w": leaf(_conv_linear(ts.get(
               vp + "conv1.weight"))), "b": None},
           "pos_embed": {"w": leaf(ts.get(vp + "positional_embedding"))},
           "ln_pre": norm(vp + "ln_pre"),
           "fc_sub_mean": {"w": leaf(sub_mean_matrix(W)), "b": None},
           "blocks": _stack(blocks, dtype, device)}
    del blocks

    # attn_pool: the MultiheadAttention's in_proj → q / k / v; the
    # matrix ``proj`` → the proj_fc linear with a zero bias
    ap = vp + "attn_pool."
    qw, kw, vw = _split_cols(ts.get(ap + "attn.in_proj_weight"),
                             [rcfg.width] * 3)
    qb, kb, vb = torch.chunk(ts.get(ap + "attn.in_proj_bias"), 3)
    proj = ts.get(vp + "proj")
    out = ts.lin(ap + "attn.out_proj")
    res = {"query": {"w": leaf(ts.get(ap + "query"))},
           "ln_q": norm(ap + "ln_q"), "ln_kv": norm(ap + "ln_kv"),
           "kv_proj": {"w": leaf(ts.get(ap + "kv_proj.weight").T),
                       "b": None},
           **{s: {"w": leaf(w), "b": leaf(bb)}
              for s, w, bb in (("q", qw, qb), ("k", kw, kb), ("v", vw, vb))},
           "out": {"w": leaf(out["w"]), "b": leaf(out["b"])},
           "ln_post": norm(vp + "ln_post"),
           "pos_embed_kv": {"w": leaf(ts.get(ap + "pos_embed"))},
           "proj_fc": {"w": leaf(proj), "b": leaf(torch.zeros(
               proj.shape[1]))}}
    ts.close()
    return {"llm": llm, "vit": vit, "res": res}


LOADERS = {"qwen2vl": load_qwen2vl, "qwenvl": load_qwenvl,
           "internvl": load_internvl, "glm4v": load_glm4v}
_UNPORTED = {"minicpmv": "A12c"}


def load_model(family_name: str, cfg, model_dir: str, dtype=None,
               device="cuda") -> Dict:
    """Load and convert an HF checkpoint into the port's layout on
    ``device``, every leaf in ``dtype`` (float32 when None, the JAX
    loader's numpy tree)."""
    if family_name in _UNPORTED:
        raise NotImplementedError(f"the {family_name} checkpoint loader is "
                                  f"not ported (ROADMAP A12, "
                                  f"{_UNPORTED[family_name]})")
    if family_name not in LOADERS:
        raise KeyError(f"unknown model family {family_name!r}")
    return LOADERS[family_name](cfg, model_dir, dtype=dtype or torch.float32,
                                device=device)
