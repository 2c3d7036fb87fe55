"""Model → eval adapter (counterpart of ``mquant_tpu/evaluation/adapter.py``):
a (quantized) Qwen2-VL, Qwen-VL, InternVL2 or GLM-4V and a tokenizer
behind ``generate(prompt)`` → text.

A request goes through the family's chat template, the aspect-ratio bucket
of each image, one vision pass per image (ViT → merger, ViT → the
resampler's 256 pooled rows, ViT → pixel shuffle → mlp1, or ViT → GLU
projector with its boi / eoi rows) spliced into the token embeddings at
the image tokens, the positions (Qwen2-VL's M-RoPE planes; the others' 1-D
arange, left to the decoder),
and the prefill and greedy decode loop of
``serve.generate.Generator``, or the continuous-batching
``serve.engine.ServingEngine`` (``engine_request``, ``serve_engine``,
``engine_server``). The tokenizer is injectable;
:class:`ByteTokenizer` needs no assets.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.registry import (ModelFamily, get_family, grid_image_features,
                               image_tokens)
from ..serve.generate import Generator


class ByteTokenizer:
    """Byte-level toy tokenizer (vocab 256) for asset-free tests."""

    eos_id = 0

    def encode(self, text: str):
        return list(text.encode("utf-8")[:2048])

    def decode(self, ids):
        return bytes(int(i) % 256 for i in ids if i != 0).decode("utf-8",
                                                                 "ignore")


class VLMRunner:
    """Drives a (possibly quantized) Qwen2-VL, Qwen-VL, InternVL2 or GLM-4V
    end to end. The images are resized into ``bucket_spec``'s buckets (default:
    the 1×1, 1×2, 2×1 and 2×2 multiples of ``image_size``, itself 4 patches
    by default). The Generator holds the LLM in its serving layout (W4 packed
    in real mode); the runner keeps that copy and not the one it was
    given. Padding the
    patch sequences to one bucket (``pad_to_max``) is not ported (ROADMAP
    A6). ``kv_quant`` (True / 8 or 4) gives the Generator, and the engine
    of :meth:`serve_engine`, an int8 / int4 KV cache."""

    def __init__(self, family_name: str, cfg, params, specs=None, state=None,
                 mode: str = "fp", tokenizer=None, max_len: int = 512,
                 image_size: Optional[int] = None, max_new_tokens: int = 24,
                 bucket_spec=None, use_chat_template: bool = True,
                 pad_to_max: bool = False, kv_quant=False):
        from ..models.buckets import BucketSpec

        if pad_to_max:
            raise NotImplementedError("padded patch sequences (pad_to_max) "
                                      "are not ported (ROADMAP A6)")
        self.fam: ModelFamily = get_family(family_name)
        self.cfg = cfg
        self.specs = specs or {}
        self.state = state
        self.mode = mode
        self.tok = tokenizer or ByteTokenizer()
        self.max_new_tokens = max_new_tokens
        self.use_chat_template = use_chat_template
        base = image_size or cfg.patch * 4
        merge = cfg.patch * 2  # grids must stay even for the 2×2 merger
        self.buckets = bucket_spec or BucketSpec(patch=cfg.patch, buckets=(
            (base, base), (base, 2 * base), (2 * base, base),
            (2 * base, 2 * base)))
        if not all(bh % merge == 0 and bw % merge == 0
                   for bh, bw in self.buckets.buckets):
            raise ValueError(f"buckets {self.buckets.buckets} are not "
                             f"multiples of {merge} px")
        self.gen = Generator(cfg.llm, params["llm"], specs=self.specs,
                             state=state, mode=mode, max_len=max_len,
                             kv_quant=kv_quant)
        self.params = {**params, "llm": self.gen.params}
        self.device = self.gen.params["embed"]["w"].device

    # -- multimodal input construction ------------------------------------

    def _encode_image(self, image: Optional[np.ndarray]):
        """image (H, W, 3 in [0, 1] or uint8) → (patches, extra,
        n_img_tokens): the bucket of the closest aspect ratio; ``extra``
        holds Qwen2-VL's ``grid_hw`` and M-RoPE grid, or the patch ``grid``
        (gh, gw) of the other families."""
        if image is None:
            return None, {}, 0
        from ..models.buckets import prepare_image
        from ..models.vision import patchify_2d, patchify_qwen2vl

        img, (gh, gw), _ = prepare_image(np.asarray(image), self.buckets)
        img = torch.from_numpy(img)[None].to(self.device)
        if self.fam.name != "qwen2vl":
            patches, _ = patchify_2d(img, self.cfg.patch)
            return patches, {"grid": (gh, gw)}, image_tokens(self.cfg, gh,
                                                             gw)
        patches, grid = patchify_qwen2vl(img, patch=self.cfg.patch)
        return patches, {"grid_hw": grid, "mrope_grid": (1, gh, gw)}, \
            gh * gw // 4

    def build_inputs(self, prompt: Dict):
        """The chat-templated token stream (1, T): text pieces interleaved
        with one span of image-pad tokens per image; ``prompt["image"]`` is
        one array or a list of them. Returns (tokens, encoded images)."""
        raw = prompt.get("image")
        images = ([] if raw is None
                  else list(raw) if isinstance(raw, (list, tuple)) else [raw])
        encoded = [self._encode_image(im) for im in images]
        n_imgs = [n for _, _, n in encoded]
        if self.use_chat_template:
            from ..serve.chat import build_multi_image_prompt

            pieces = build_multi_image_prompt(
                self.fam.name, prompt["text"], n_imgs,
                system=prompt.get("system"), history=prompt.get("history"),
                encode=self.tok.encode)
            toks: list = []
            for p in pieces:
                if p["kind"] == "text":
                    toks += list(self.tok.encode(p["text"]))
                else:
                    toks += [self.cfg.image_token_id] * p["n_tokens"]
        else:
            toks = sum(([self.cfg.image_token_id] * n for n in n_imgs),
                       []) + list(self.tok.encode(prompt["text"]))
        arr = np.asarray(toks, np.int64)[None]
        img_mask = arr == self.cfg.image_token_id
        arr = np.clip(arr, 0, self.cfg.llm.vocab - 1)
        arr[img_mask] = self.cfg.image_token_id  # survive the clip
        return torch.from_numpy(arr).to(self.device), encoded

    def _embeds(self, toks, encoded):
        """(spliced embeddings (1, T, hidden), M-RoPE positions (3, 1, T)
        as numpy from the images' grids, or None for a family with 1-D
        positions)."""
        from ..models.qwen2vl import mrope_positions

        grids = [g for g in (e.pop("mrope_grid", None) for _, e, _ in encoded)
                 if g is not None]
        emb = _embed_with_quant(self.fam, self.cfg, self.params,
                                {"tokens": toks, "images": encoded},
                                self.specs, self.state, self.mode)
        if self.fam.name != "qwen2vl":
            return emb, None
        pos = mrope_positions(toks.cpu().numpy(), self.cfg.image_token_id,
                              grid_thw=grids or None)
        return emb, pos

    # -- generation ---------------------------------------------------------

    @torch.no_grad()
    def generate_batch(self, prompts, max_new_tokens: Optional[int] = None):
        """Several prompts (other lengths, images or none) in ONE ragged
        batch: per-prompt vision passes and splice, then the left-padded
        batch decode (``Generator.generate_batch``) with each row's M-RoPE
        positions (none for 1-D positions). Returns the decoded strings."""
        max_new = max_new_tokens or self.max_new_tokens
        embeds, positions = [], []
        for p in prompts:
            emb, pos = self._embeds(*self.build_inputs(p))
            embeds.append(emb[0])  # (T_i, hidden)
            positions.append(pos)
        self.gen.ensure_capacity(max(int(e.shape[0]) for e in embeds)
                                 + max_new)
        eos = getattr(self.tok, "eos_id", -1)
        outs = self.gen.generate_batch(
            embeds, max_new_tokens=max_new, eos_id=eos if eos >= 0 else None,
            positions=None if positions[0] is None else positions)
        return [self.tok.decode(o) for o in outs]

    @torch.no_grad()
    def generate(self, prompt: Dict, max_new_tokens: Optional[int] = None,
                 on_first_token: Optional[Callable] = None) -> str:
        """prompt {"text": str, "image": array | list | None} → decoded
        text: ``max_new_tokens`` greedy tokens, cut before the first eos.
        ``on_first_token`` is called with the (1, 1) first token as soon as
        it is issued."""
        max_new = max_new_tokens or self.max_new_tokens
        toks, encoded = self.build_inputs(prompt)
        embeds, pos = self._embeds(toks, encoded)
        positions = (torch.from_numpy(pos).to(self.device)
                     if encoded and pos is not None else None)
        eos = getattr(self.tok, "eos_id", -1)
        # the cache holds the (bucket-padded) prompt and every new token
        self.gen.ensure_capacity(toks.shape[1] + max_new)
        seq = self.gen.generate_on_device(
            embeds, max_new, positions=positions,
            on_first_token=on_first_token)[0].tolist()
        out = []
        for t in seq:
            if t == eos:
                break
            out.append(t)
        return self.tok.decode(out)


    @torch.no_grad()
    def engine_request(self, prompt: Dict) -> Dict:
        """One prompt → ``ServingEngine.submit`` kwargs: the spliced embeds
        (T, hidden) as a tensor on the runner's device, the M-RoPE positions
        (3, T) (None for 1-D positions) and the prompt's token ids
        (speculation's draft history, prefix matching, penalties). It runs the vision tower: callers with
        a scheduler thread (``serve.server``) call it there."""
        toks, encoded = self.build_inputs(prompt)
        emb, pos = self._embeds(toks, encoded)
        return {"tokens_or_embeds": emb[0],
                "positions": None if pos is None else pos[:, 0],
                "draft_ids": toks.cpu().numpy().reshape(-1)}

    def new_engine(self, slots: int, max_len: int, **engine_kw):
        """A ``ServingEngine`` over this runner's decoder: its quantization
        state, the ``Generator``'s packed weights (shared, not copied), its
        KV storage (unless ``kv_quant`` is given) and the tokenizer's
        eos."""
        from ..serve.engine import ServingEngine

        eos = getattr(self.tok, "eos_id", -1)
        engine_kw.setdefault("kv_quant", self.gen.kv_quant)
        return ServingEngine(self.cfg.llm, self.gen.params, specs=self.specs,
                             state=self.state, mode=self.mode, slots=slots,
                             max_len=max_len,
                             eos_id=eos if eos >= 0 else None, **engine_kw)

    @torch.no_grad()
    def serve_engine(self, prompts, max_new_tokens: Optional[int] = None,
                     engine=None, slots: int = 4, steps_per_block: int = 8,
                     spec_k: int = 0, admit_chunk: int = 0):
        """Serve prompts through the continuous-batching ``ServingEngine``:
        each prompt's vision pass and splice here, then one pool request
        each with its M-RoPE positions. ``engine=`` reuses a warm engine
        (its graphs and prefix cache). Returns decoded strings in prompt
        order."""
        from ..serve.generate import bucket_len

        max_new = max_new_tokens or self.max_new_tokens
        reqs = [self.engine_request(p) for p in prompts]
        if engine is None:
            tmax = max(int(r["tokens_or_embeds"].shape[0]) for r in reqs)
            # whole-prompt admission writes the padded prompt bucket;
            # speculation overhangs by spec_k rows
            engine = self.new_engine(
                slots, bucket_len(bucket_len(tmax, 16) + max_new + spec_k),
                steps_per_block=steps_per_block, spec_k=spec_k,
                admit_chunk=admit_chunk)
        rids = [engine.submit(max_new_tokens=max_new, **r) for r in reqs]
        outs = engine.run()
        texts = [self.tok.decode(outs[r]) for r in rids]
        for r in rids:  # warm engines are reused across batches
            engine.release(r)
        return texts

    def engine_server(self, max_len: int = 1024, slots: int = 4,
                      max_new_tokens: Optional[int] = None, **engine_kw):
        """A list → list batch function backed by ONE warm engine (graphs
        and prefix cache reused across calls); ``batch_fn.engine`` exposes
        it."""
        from ..serve.generate import bucket_len

        eng = self.new_engine(slots, bucket_len(max_len), **engine_kw)

        def batch_fn(prompts, mnt=None):
            return self.serve_engine(
                prompts, max_new_tokens=mnt or max_new_tokens, engine=eng)

        batch_fn.engine = eng
        return batch_fn


def _embed_with_quant(fam, cfg, params, batch, specs, state, mode):
    """Token embeddings with the image features spliced in, the vision path
    in ``mode``. ``batch["images"]``: (patches, extra, n_img_tokens) per
    image; the tower runs once per image and the i-th image-token span
    takes the i-th image's rows."""
    from ..models.qwen2vl import splice_image_embeds

    toks = batch["tokens"]
    embeds = params["llm"]["embed"]["w"][toks].to(cfg.llm.dtype)
    images = [im for im in batch.get("images") or () if im[0] is not None]
    if not images:
        return embeds
    feats = [_image_features(fam, cfg, params, p, e, specs, state, mode,
                             n_img=n) for p, e, n in images]
    img = torch.cat(feats, dim=1) if len(feats) > 1 else feats[0]
    return splice_image_embeds(embeds, toks, img, cfg.image_token_id)


def _image_features(fam, cfg, params, patches, extra, specs, state, mode,
                    n_img=None):
    """One image's projected features (B, N_i, hidden), trimmed to its
    ``n_img`` image tokens (Qwen2-VL's ViT → merger, Qwen-VL's ViT →
    resampler, InternVL2's ViT → pixel shuffle → mlp1, GLM-4V's ViT → GLU
    projector; ``get_family`` refuses MiniCPM-V)."""
    from ..models.vision import merger_forward, vit_forward

    vmask = extra.get("vis_token_mask")
    image_features = grid_image_features(fam.name)
    if image_features is not None:
        if vmask is not None:
            raise NotImplementedError("vision token masks (padded patch "
                                      "sequences) are not ported (ROADMAP "
                                      "A6)")
        img, _ = image_features(cfg, params, patches, extra["grid"], specs,
                                state, mode)
        return img if n_img is None else img[:, :n_img]
    feats, _ = vit_forward(cfg.vit, params["vit"], patches, specs, state,
                           mode, grid_hw=extra.get("grid_hw"),
                           token_mask=vmask)
    img, _ = merger_forward(cfg.merger, params["merger"], feats, specs,
                            state, mode, token_mask=vmask)
    if n_img is not None and img.shape[1] > n_img:
        img = img[:, :n_img]
    return img


def calib_batches_from_dataset(runner: VLMRunner, dataset, n: int):
    """Real multimodal-prompt calibration batches from an eval dataset (JAX
    ``calib_batches_from_dataset``). The reference calibrates by driving
    ``model.generate`` over real VQA prompts (ref: quant_utils.py:1079-1129
    calib_vqa_plus); here each of the first ``n`` rows goes through the SAME
    chat-template + resolution-bucket input construction as generation
    (``VLMRunner.build_inputs``), so the calibration distribution matches
    what serving sees. A multi-image row calibrates on its first image (the
    batch carries one ``patches``). Returns pipeline batches {"tokens" (1,
    T), "patches" (1, N, patch_dim) or None, and the family's extras:
    "grid_hw" or "grid"}; rows differ in T and in their image's bucket."""
    out = []
    for i in range(min(n, len(dataset))):
        prompt = dataset.build_prompt(i)
        img = prompt.get("image")
        if isinstance(img, (list, tuple)):
            prompt = dict(prompt)
            prompt["image"] = img[0] if img else None
        toks, encoded = runner.build_inputs(prompt)
        batch = {"tokens": toks, "patches": None}
        if encoded:
            patches, extra, _ = encoded[0]  # one image per calibration row
            batch["patches"] = patches
            batch.update({k: v for k, v in extra.items()
                          if k != "mrope_grid"})
        out.append(batch)
    return out
