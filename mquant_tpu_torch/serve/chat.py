"""Chat prompt construction per model family (the port's copy of
``mquant_tpu/serve/chat.py``): the families' chat templates (ChatML with
Qwen2-VL's vision start / end around the image pads, Qwen-VL's and
InternVL's numbered pictures, MiniCPM-V's and GLM-4V's spans), history
turns with the newest-first token window, and the ordered text / image
pieces a runner encodes. The image-slot count comes from the caller.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple


def render_history(family: str, history: List[Tuple[str, Optional[str]]],
                   system: str, max_window_size: int = 6144,
                   encode: Optional[Callable[[str], list]] = None) -> str:
    """History turns → the family's REAL per-turn chat markup, newest-first
    window truncation (protocol parity: the reference renders every history
    turn as full ChatML with a token-budget walk, model/
    qwen_generation_utils.py:128-171 — not role-prefixed prose).

    ``history``: [(user_q, assistant_a)], a may be None (query-only turn, ref
    :150-153). ``encode`` counts tokens for the window walk exactly like the
    reference (each <|im_start|>/<|im_end|> special = 1 token); without a
    tokenizer every turn is kept (truncation needs token counts)."""
    if not history:
        return ""
    if family == "glm4v":
        # GLM-4 chat convention: <|user|>/<|assistant|> role blocks inside
        # the leading <|user|>\n. Query-only turns keep their question (same
        # treatment the ChatML branch gives them, ref :150-153), and the
        # newest-first token-budget walk mirrors the ChatML one (each
        # <|user|>/<|assistant|>/[gMASK]/<sop> special counts 1 token).
        def glm_turn(q, a):
            if a is None:
                return f"{q}<|user|>\n"
            return f"{q}<|assistant|>\n{a}<|user|>\n"

        if encode is None:
            kept = list(history)
        else:
            nl = len(encode("\n"))
            head = 3 + nl  # [gMASK] + <sop> + <|user|> + "\n"
            ctx = 0
            kept = []
            for q, a in reversed(history):
                nxt = len(encode(q)) + 1 + nl
                if a is not None:
                    nxt += len(encode(a)) + 1 + nl
                if head + nxt + ctx < max_window_size:
                    kept.insert(0, (q, a))
                    ctx += nxt
                else:
                    break
        return "".join(glm_turn(q, a) for q, a in kept)

    def turn_text(q, a):
        t = f"\n<|im_start|>user\n{q}<|im_end|>\n"
        if a is not None:
            t += f"<|im_start|>assistant\n{a}<|im_end|>"
        return t

    if encode is None:
        kept = list(history)
    else:
        nl = len(encode("\n"))
        # system block tokens: im_start + "system" + nl + content + im_end
        sys_len = 2 + len(encode("system")) + nl + len(encode(system))
        ctx = 0
        kept = []
        for q, a in reversed(history):
            qt = 2 + len(encode("user")) + nl + len(encode(q))
            nxt = nl + qt + nl
            if a is not None:
                nxt += 2 + len(encode("assistant")) + nl + len(encode(a))
            if sys_len + nxt + ctx < max_window_size:
                kept.insert(0, (q, a))
                ctx += nxt
            else:
                break
    return "".join(turn_text(q, a) for q, a in kept)


def build_chat_prompt(family: str, question: str, n_image_tokens: int,
                      system: Optional[str] = None,
                      history: Optional[List[Tuple[str, Optional[str]]]] = None,
                      max_window_size: int = 6144,
                      encode: Optional[Callable[[str], list]] = None) -> dict:
    """→ {"text_before", "text_after", "image_slot"} pieces; the runner encodes
    text pieces and splices ``n_image_tokens`` image-pad tokens between them.

    ``history``: earlier (question, answer) turns rendered as REAL per-turn
    chat markup between the system block and the final user turn (ref:
    make_context, model/qwen_generation_utils.py:128-187), truncated
    newest-first against ``max_window_size`` when ``encode`` is given."""
    system = system or "You are a helpful assistant."
    hist = render_history(family, history or [], system,
                          max_window_size=max_window_size, encode=encode)
    # chat scaffolding around the final user turn, with history turns spliced
    # between the system block and the final <|im_start|>user
    sys_block = f"<|im_start|>system\n{system}<|im_end|>{hist}\n<|im_start|>user\n"
    mcpm_head = (hist[1:] + "\n" if hist else "") + "<|im_start|>user\n"
    if n_image_tokens == 0:
        # text-only context: same chat scaffold, no image markers
        if family == "glm4v":
            return {"text_before": "[gMASK]<sop><|user|>\n" + hist,
                    "text_after": f"{question}<|assistant|>\n",
                    "n_image_tokens": 0}
        before = sys_block if family != "minicpmv" else mcpm_head
        return {"text_before": before,
                "text_after": f"{question}<|im_end|>\n<|im_start|>assistant\n",
                "n_image_tokens": 0}
    if family == "qwen2vl":
        before = sys_block + "<|vision_start|>"
        after = f"<|vision_end|>{question}<|im_end|>\n<|im_start|>assistant\n"
    elif family == "qwenvl":
        # ChatML with Picture tags (ref: make_context + from_list_format)
        before = sys_block + "Picture 1: <img>"
        after = f"</img>\n{question}<|im_end|>\n<|im_start|>assistant\n"
    elif family == "internvl":
        before = sys_block + "<img>"
        after = f"</img>\n{question}<|im_end|>\n<|im_start|>assistant\n"
    elif family == "minicpmv":
        before = mcpm_head + "<image>"
        after = f"</image>\n{question}<|im_end|>\n<|im_start|>assistant\n"
    elif family == "glm4v":
        before = "[gMASK]<sop><|user|>\n" + hist
        after = f"\n{question}<|assistant|>\n"
    else:
        before, after = "", question
    return {"text_before": before, "text_after": after,
            "n_image_tokens": n_image_tokens}


def build_multi_image_prompt(family: str, question: str,
                             n_tokens_per_image: List[int],
                             system: Optional[str] = None,
                             history: Optional[List[Tuple[str, Optional[str]]]] = None,
                             max_window_size: int = 6144,
                             encode: Optional[Callable[[str], list]] = None) -> List[dict]:
    """Multi-image chat context → ordered pieces
    [{"kind": "text", "text": ...} | {"kind": "image", "n_tokens": ...}].

    Image markup parity per family: Qwen-VL numbers pictures
    ("Picture k: <img>…</img>\\n", ref: model/tokenization_qwen.py
    from_list_format + modeling_qwen_opt.py:598-616 multi-span handling),
    Qwen2-VL repeats <|vision_start|>…<|vision_end|>, InternVL numbers
    "Image-k: <img>…</img>\\n", MiniCPM-V repeats <image>…</image>, GLM-4V
    repeats its boi/eoi span. ``history``: see :func:`build_chat_prompt` —
    earlier text turns rendered as real per-turn markup before the final
    (image-bearing) user turn."""
    system = system or "You are a helpful assistant."
    k = len(n_tokens_per_image)
    if k == 0:
        p = build_chat_prompt(family, question, 0, system=system,
                              history=history,
                              max_window_size=max_window_size, encode=encode)
        return [{"kind": "text", "text": p["text_before"] + p["text_after"]}]
    if k == 1:
        p = build_chat_prompt(family, question, n_tokens_per_image[0],
                              system=system, history=history,
                              max_window_size=max_window_size, encode=encode)
        return [{"kind": "text", "text": p["text_before"]},
                {"kind": "image", "n_tokens": p["n_image_tokens"]},
                {"kind": "text", "text": p["text_after"]}]

    hist = render_history(family, history or [], system,
                          max_window_size=max_window_size, encode=encode)
    sys_head = f"<|im_start|>system\n{system}<|im_end|>{hist}\n<|im_start|>user\n"
    if family == "glm4v":
        head, tail = "[gMASK]<sop><|user|>\n" + hist, f"\n{question}<|assistant|>\n"
        open_tag, close_tag, numbered = "", "", None
    elif family == "qwen2vl":
        head = sys_head
        tail = f"{question}<|im_end|>\n<|im_start|>assistant\n"
        open_tag, close_tag, numbered = "<|vision_start|>", "<|vision_end|>", None
    elif family == "qwenvl":
        head = sys_head
        tail = f"{question}<|im_end|>\n<|im_start|>assistant\n"
        open_tag, close_tag, numbered = "<img>", "</img>\n", "Picture {k}: "
    elif family == "internvl":
        head = sys_head
        tail = f"{question}<|im_end|>\n<|im_start|>assistant\n"
        open_tag, close_tag, numbered = "<img>", "</img>\n", "Image-{k}: "
    elif family == "minicpmv":
        head = (hist[1:] + "\n" if hist else "") + "<|im_start|>user\n"
        tail = (f"\n{question}<|im_end|>\n<|im_start|>assistant\n")
        open_tag, close_tag, numbered = "<image>", "</image>", None
    else:
        head, tail, open_tag, close_tag, numbered = "", question, "", "", None

    pieces: List[dict] = []
    text = head
    for i, n in enumerate(n_tokens_per_image):
        if numbered:
            text += numbered.format(k=i + 1)
        text += open_tag
        pieces.append({"kind": "text", "text": text})
        pieces.append({"kind": "image", "n_tokens": n})
        text = close_tag
    pieces.append({"kind": "text", "text": text + tail})
    return pieces
