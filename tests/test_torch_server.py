"""The port's HTTP front end (``mquant_tpu_torch/serve/server.py``) against
``mquant_tpu/serve/server.py``: the cases of ``tests/test_server.py``, each
request posted to a JAX server and to the port's on the same weights
(``test_torch_engine.Model``: numpy-seeded, tiny f32), responses equal
(tokens, text, finish reason; logprobs within 1e-5). The VLM cases serve
one realized W4A8 artifact of the port's own pipeline (tiny Qwen2-VL)
through both packages' ``build_server_from_artifact``. Image parts are PNGs
read by the port's ``utils.png`` (held equal to PIL's decode here); the CLI
runs in a subprocess on the CPU.
"""

import base64
import http.client
import io
import json
import re
import socket
import struct
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from mquant_tpu.serve.chat import build_chat_prompt
from mquant_tpu.serve.engine import ServingEngine as JEngine
from mquant_tpu.serve.server import InferenceServer as JServer
from mquant_tpu.serve.server import \
    build_server_from_artifact as j_build_server
from mquant_tpu_torch import pipeline as TP
from mquant_tpu_torch.serve.engine import ServingEngine as TEngine
from mquant_tpu_torch.serve.server import EngineWorker, InferenceServer
from mquant_tpu_torch.serve.server import build_server_from_artifact
from mquant_tpu_torch.utils.png import decode_png, encode_png
from test_torch_engine import Model, poisoned
from torch_threads import _one_torch_thread  # noqa: F401

LP_ATOL = 1e-5


class ToyTokenizer:
    """One id per character, mod vocab (tests/test_server.py's)."""

    def encode(self, s):
        return [1 + (ord(c) % 90) for c in s]

    def decode(self, ids):
        return "".join(chr(97 + (t % 26)) for t in ids)


def _conn(port):
    return http.client.HTTPConnection("127.0.0.1", port, timeout=120)


def _post(port, path, body):
    c = _conn(port)
    c.request("POST", path, json.dumps(body),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, json.loads(data)


def _get(port, path):
    c = _conn(port)
    c.request("GET", path)
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, data


def _pair(m, tok=None, **kw):
    """(JAX server, port server) over engines of ``kw`` on ``m``."""
    je, te = m.engines(**kw)
    return (JServer(je, tokenizer=tok, port=0),
            InferenceServer(te, tokenizer=tok, port=0))


def _same(pair, path, body):
    """Post ``body`` to both servers; statuses and bodies equal (logprobs
    within LP_ATOL). Returns the port's."""
    (sj, oj), (st, ot) = (_post(s.port, path, body) for s in pair)
    assert st == sj, (ot, oj)
    lj = [c.pop("logprobs", None) for c in oj.get("choices", [])]
    lt = [c.pop("logprobs", None) for c in ot.get("choices", [])]
    assert ot == oj
    for a, b in zip(lt, lj):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a["token_logprobs"],
                                       b["token_logprobs"], atol=LP_ATOL)
    for c, lp in zip(ot.get("choices", []), lt):
        if lp is not None:
            c["logprobs"] = lp
    return st, ot


@pytest.fixture(scope="module")
def model():
    return Model(0)


@pytest.fixture(scope="module")
def served(model):
    pair = _pair(model, ToyTokenizer(), slots=2, max_len=128,
                 steps_per_block=3)
    yield model, pair
    for s in pair:
        s.shutdown()


@pytest.fixture(scope="module")
def sampling(model):
    pair = _pair(model, ToyTokenizer(), slots=3, max_len=128,
                 steps_per_block=3, sample_top_k=8, seed=5)
    yield pair
    for s in pair:
        s.shutdown()


# -- completions --------------------------------------------------------------


def test_ids_and_text_prompts_match_jax_and_solo(served):
    m, pair = served
    st, out = _same(pair, "/v1/completions",
                    {"prompt": list(range(1, 9)), "max_tokens": 7})
    assert st == 200 and out["usage"]["completion_tokens"] == 7
    assert out["choices"][0]["tokens"] == m.solo(range(1, 9), 7)
    st, out = _same(pair, "/v1/completions", {"prompt": "hello",
                                              "max_tokens": 4})
    assert out["choices"][0]["tokens"] == m.solo(
        ToyTokenizer().encode("hello"), 4)


def test_concurrent_requests_all_exact(served):
    m, (_, srv) = served
    prompts = [list(range(1 + 7 * i, 6 + 7 * i)) for i in range(5)]
    res = [None] * 5

    def go(i):
        res[i] = _post(srv.port, "/v1/completions",
                       {"prompt": prompts[i], "max_tokens": 6})[1]

    ts = [threading.Thread(target=go, args=(i,)) for i in range(5)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
        assert not t.is_alive()
    for i, p in enumerate(prompts):
        assert res[i]["choices"][0]["tokens"] == m.solo(p, 6)


@pytest.mark.parametrize("body", [
    {"prompt": [], "max_tokens": 2}, {"prompt": {"not": "valid"}},
    {"prompt": list(range(1, 300)), "max_tokens": 8},
    {"prompt": [1, 2, 3], "max_tokens": 3, "temperature": 0.7},
    {"prompt": [1, 2, 3], "max_tokens": 3, "frequency_penalty": 0.5},
    {"prompt": [1, 2], "n": 2}, {"prompt": [1, 2], "n": 9}])
def test_bad_requests_are_400(served, body):
    _, pair = served
    st, out = _same(pair, "/v1/completions", body)
    assert st == 400 and "error" in out


def test_streaming_concatenates_to_full(served):
    m, (_, srv) = served
    prompt = list(range(3, 11))
    c = _conn(srv.port)
    c.request("POST", "/v1/completions",
              json.dumps({"prompt": prompt, "max_tokens": 9, "stream": True}),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    assert r.status == 200
    assert r.getheader("Content-Type") == "text/event-stream"
    body = r.read().decode()
    c.close()
    events = [ln[6:] for ln in body.split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    got = sum((json.loads(e)["choices"][0]["tokens"] for e in events[:-1]),
              [])
    assert got == m.solo(prompt, 9)
    assert len(events) - 1 >= 2  # block granularity, not one blob


def test_stream_disconnect_frees_slot(served):
    m, (_, srv) = served
    c = _conn(srv.port)
    c.request("POST", "/v1/completions",
              json.dumps({"prompt": list(range(1, 7)), "max_tokens": 64,
                          "stream": True}),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    r.read(40)
    c.sock.shutdown(socket.SHUT_RDWR)
    c.sock.close()
    st, out = _post(srv.port, "/v1/completions",
                    {"prompt": list(range(8, 14)), "max_tokens": 5})
    assert st == 200
    assert out["choices"][0]["tokens"] == m.solo(range(8, 14), 5)
    for _ in range(200):
        if srv.worker.cancelled_total >= 1:
            break
        time.sleep(0.05)
    assert srv.worker.cancelled_total >= 1
    for _ in range(200):
        if srv.worker.stats()["active"] == 0:
            break
        time.sleep(0.05)
    text = _get(srv.port, "/metrics")[1].decode()
    assert "mquant_active 0" in text and "mquant_cancelled_total" in text


# -- chat and ops ----------------------------------------------------------


def test_chat_completion_and_multi_turn(served):
    m, pair = served
    st, out = _same(pair, "/v1/chat/completions", {"messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "hi"}], "max_tokens": 5})
    assert st == 200 and out["object"] == "chat.completion"
    pieces = build_chat_prompt("qwen2vl", "hi", 0, system="be brief")
    ids = ToyTokenizer().encode(pieces["text_before"] + pieces["text_after"])
    assert out["choices"][0]["tokens"] == m.solo(ids, 5)
    assert _same(pair, "/v1/chat/completions", {"messages": []})[0] == 400


def test_multi_turn_chat_renders_real_chatml(model):
    pair = _pair(model, ToyTokenizer(), slots=2, max_len=256,
                 steps_per_block=3)
    try:
        msgs = [{"role": "system", "content": "be brief"},
                {"role": "user", "content": "first q"},
                {"role": "assistant", "content": "first a"},
                {"role": "user", "content": "second q"}]
        st, out = _same(pair, "/v1/chat/completions",
                        {"messages": msgs, "max_tokens": 5})
    finally:
        for s in pair:
            s.shutdown()
    assert st == 200
    tok = ToyTokenizer()
    pieces = build_chat_prompt("qwen2vl", "second q", 0, system="be brief",
                               history=[("first q", "first a")],
                               encode=tok.encode)
    text = pieces["text_before"] + pieces["text_after"]
    assert "<|im_start|>assistant\nfirst a<|im_end|>" in text
    assert out["choices"][0]["tokens"] == model.solo(tok.encode(text), 5)


def test_health_models_metrics_404(served):
    _, (_, srv) = served
    st, body = _get(srv.port, "/health")
    assert st == 200 and json.loads(body)["status"] == "ok"
    assert json.loads(_get(srv.port, "/v1/models")[1])["data"][0]["id"] \
        == "mquant-tpu"
    st, body = _get(srv.port, "/metrics")
    assert st == 200 and "mquant_slots 2" in body.decode()
    assert "mquant_requests_total" in body.decode()
    assert _get(srv.port, "/nope")[0] == 404
    _post(srv.port, "/v1/completions", {"prompt": [5, 6, 7],
                                        "max_tokens": 3})
    s = srv.worker.stats()
    assert s["request_count"] >= 1 and s["request_seconds_sum"] > 0


def test_stop_strings(served):
    m, pair = served
    text = ToyTokenizer().decode(m.solo(range(1, 7), 24))
    stop = text[8:11]
    st, out = _same(pair, "/v1/completions",
                    {"prompt": list(range(1, 7)), "max_tokens": 24,
                     "stop": stop})
    c = out["choices"][0]
    assert c["finish_reason"] == "stop"
    assert c["text"] == text[:text.find(stop)] and len(c["tokens"]) < 24
    st, out = _same(pair, "/v1/completions",
                    {"prompt": [3, 4, 5], "max_tokens": 5,
                     "stop": ["@@@never@@@"]})
    assert out["choices"][0]["finish_reason"] == "length"


def test_logprobs_field(served):
    _, pair = served
    st, out = _same(pair, "/v1/completions",
                    {"prompt": [2, 3, 4], "max_tokens": 4, "logprobs": True})
    lp = out["choices"][0]["logprobs"]["token_logprobs"]
    assert len(lp) == 4 and all(v <= 0 for v in lp)
    st, out = _same(pair, "/v1/completions", {"prompt": [2, 3, 4],
                                              "max_tokens": 2})
    assert "logprobs" not in out["choices"][0]


# -- sampling -----------------------------------------------------------------


def test_sampled_requests_match_jax(sampling):
    """Seeded, engine-seeded, n > 1 and penalized requests: the same tokens
    and logprobs as JAX's server; a seed replays."""
    bodies = [
        {"prompt": list(range(2, 9)), "max_tokens": 8, "temperature": 1.2,
         "seed": 123, "logprobs": True},
        {"prompt": list(range(2, 9)), "max_tokens": 8, "temperature": 1.2,
         "seed": 123, "n": 3},
        {"prompt": list(range(1, 8)), "max_tokens": 8, "temperature": 2.0,
         "top_p": 0.9, "seed": 7, "presence_penalty": 0.5,
         "frequency_penalty": 0.5},
        {"prompt": [1, 2], "n": 2, "stream": True, "temperature": 1.0}]
    outs = [_same(sampling, "/v1/completions", b) for b in bodies]
    assert [o[0] for o in outs] == [200, 200, 200, 400]
    toks = [tuple(c["tokens"]) for c in outs[1][1]["choices"]]
    assert toks[0] == tuple(outs[0][1]["choices"][0]["tokens"])
    assert len(set(toks)) > 1 and outs[1][1]["usage"]["completion_tokens"] \
        == 24
    assert _same(sampling, "/v1/completions", bodies[0])[1] == outs[0][1]


# -- engines behind the server ----------------------------------------------


def test_server_over_speculative_engine_and_chunked_admission(model):
    p_long = [1 + (i % 90) for i in range(60)]
    for kw in (dict(steps_per_block=2, spec_k=4),
               dict(steps_per_block=3, admit_chunk=32)):
        pair = _pair(model, None, slots=2, max_len=128, **kw)
        try:
            st, out = _same(pair, "/v1/completions",
                            {"prompt": list(range(2, 12)), "max_tokens": 8,
                             "logprobs": True})
            assert out["choices"][0]["tokens"] == model.solo(range(2, 12), 8)
            st, out = _same(pair, "/v1/completions",
                            {"prompt": p_long, "max_tokens": 6})
            assert out["choices"][0]["tokens"] == model.solo(p_long, 6)
        finally:
            for s in pair:
                s.shutdown()


def test_worker_crash_fails_requests_instead_of_hanging(model):
    eng = TEngine(model.tc, model.pt, slots=1, max_len=64)

    def boom(*a, **k):
        raise RuntimeError("injected engine failure")

    eng.step_block = boom
    w = EngineWorker(eng)
    p = w.submit([1, 2, 3], max_new_tokens=4)
    assert p.done.wait(30)
    assert "injected engine failure" in p.error
    for _ in range(100):
        if w.crashed:
            break
        time.sleep(0.05)
    p2 = w.submit([4, 5], max_new_tokens=2)
    assert p2.done.wait(5) and p2.error
    with pytest.raises(RuntimeError):
        w.call(lambda e: e.stats())
    w.shutdown()


def test_releases_bookkeeping_and_worker_call(model):
    eng = poisoned(TEngine(model.tc, model.pt, slots=2, max_len=128,
                           steps_per_block=3))
    srv = InferenceServer(eng, port=0)
    try:
        owner = srv.worker.call(lambda e: threading.current_thread().name)
        assert owner == "mquant-engine-worker"
        srv.worker.call(lambda e: e.register_prefix([1, 2, 3, 4]))
        for i in range(3):
            assert _post(srv.port, "/v1/completions",
                         {"prompt": [1, 2, 3, 4, 5 + i],
                          "max_tokens": 3})[0] == 200
        assert len(eng._requests) == 0 and eng.prefix_hits == 3
        with pytest.raises(ZeroDivisionError):
            srv.worker.call(lambda e: 1 / 0)
    finally:
        srv.shutdown()


def test_mesh_raises(model):
    """``mesh=`` serves tensor parallel (tests/test_torch_sharding_serving.py)
    but takes only a mesh with its process groups."""
    from mquant_tpu_torch.parallel.sharding import slice_mesh

    eng = TEngine(model.tc, model.pt, slots=1, max_len=64)
    with pytest.raises(TypeError, match="Mesh"):
        InferenceServer(eng, port=0, mesh=object())
    with pytest.raises(ValueError, match="make_mesh"):
        InferenceServer(eng, port=0, mesh=slice_mesh(0, 2))


# -- VLM: a realized artifact of the port's pipeline, both packages ----------


def _png_url(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def vlm_pair(tmp_path_factory):
    art = str(tmp_path_factory.mktemp("art") / "art")
    TP.run_pipeline("qwen2vl", TP.QuantizeConfig(calib_num=16, nsamples=8,
                                                 realize_int=True),
                    tiny=True, artifact_dir=art, device="cpu")
    pair = (j_build_server(art, slots=2, max_len=256, port=0),
            build_server_from_artifact(art, slots=2, max_len=256, port=0,
                                       device="cpu"))
    yield pair
    for s in pair:
        s.shutdown()


def test_artifact_image_and_text_chat_match_jax(vlm_pair):
    """Image chat (vision on the scheduler thread, spliced embeds in the
    pool), text chat and an id completion on the realized artifact: equal
    to JAX's server and to the port's ``serve_engine``."""
    assert vlm_pair[1].worker.engine.mode == "real"
    arr = (np.random.default_rng(0).random((24, 24, 3)) * 255).astype(
        np.uint8)
    st, out = _same(vlm_pair, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": [
            {"type": "text", "text": "what is this?"},
            {"type": "image_url", "image_url": {"url": _png_url(arr)}}]}],
        "max_tokens": 6})
    assert st == 200, out
    runner = vlm_pair[1].vlm_runner
    want = runner.serve_engine([{"text": "what is this?", "image": arr}],
                               max_new_tokens=6)[0]
    assert out["choices"][0]["message"]["content"] == want
    st, out = _same(vlm_pair, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hello"}], "max_tokens": 4})
    assert st == 200
    st, out = _same(vlm_pair, "/v1/completions",
                    {"prompt": list(range(1, 9)), "max_tokens": 5})
    ref = runner.gen.generate(torch.arange(1, 9)[None], 5, eos_id=0)
    ref = ref[0].tolist()
    assert out["choices"][0]["tokens"] == ref[:ref.index(0) if 0 in ref
                                              else 5]


def _png_bytes(w, h, idat):
    """An 8-bit RGB PNG whose header says ``w`` × ``h`` around ``idat``."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


# decompression bombs: a header of 4e8 pixels, and 8 MiB of zeros (8 KiB
# compressed) behind a 4 × 4 header
_BOMBS = [(_png_bytes(20000, 20000, zlib.compress(bytes(64))),
           "exceed the limit"),
          (_png_bytes(4, 4, zlib.compress(bytes(8 << 20))),
           "more image data")]


@pytest.mark.parametrize("url,names", [
    ("data:image/png;base64,notbase64!!", "bad image"),
    *[("data:image/png;base64," + base64.b64encode(b).decode(), n)
      for b, n in _BOMBS],
    ("data:image/jpeg;base64,"
     + base64.b64encode(b"\xff\xd8\xff\xe0" + bytes(20)).decode(), "JPEG"),
    ("data:image/gif;base64," + base64.b64encode(b"GIF89a" + bytes(20)
                                                 ).decode(), "GIF")])
def test_bad_image_is_400_naming_the_format(vlm_pair, url, names):
    st, out = _post(vlm_pair[1].port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": url}}]}],
        "max_tokens": 4})
    assert st == 400 and names in out["error"]


# -- the PNG reader ------------------------------------------------------------


def _png_with_filters(px, filters):
    """An 8-bit PNG of ``px`` (H, W, C) with row y filtered by
    ``filters[y % len]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, ch = px.shape
    rows = px.reshape(h, w * ch).astype(np.int64)
    raw = b""
    prev = np.zeros(w * ch, np.int64)
    for y in range(h):
        f, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int64), prev[:-ch]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        raw += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_png_reader_equal_to_pil(ch):
    """Gray, gray + alpha, RGB and RGBA with each of the five filters, and
    PIL's own encoding: equal to PIL's ``convert("RGB")``."""
    rng = np.random.default_rng(ch)
    px = (rng.random((19, 23, ch)) * 255).astype(np.uint8)
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[ch]
    datas = [_png_with_filters(px, (f,)) for f in range(5)]
    datas.append(_png_with_filters(px, (0, 1, 2, 3, 4)))
    buf = io.BytesIO()
    Image.fromarray(px[..., 0] if ch == 1 else px, mode).save(buf, "PNG")
    datas.append(buf.getvalue())
    for data in datas:
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_png(data), want)
    rgb = px[..., :3] if ch >= 3 else np.repeat(px[..., :1], 3, axis=2)
    for f in range(5):
        data = encode_png(rgb, f)
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(data))), rgb)
        np.testing.assert_array_equal(decode_png(data), rgb)


@pytest.mark.parametrize("data,names", _BOMBS)
def test_png_reader_refuses_a_bomb_before_inflating_it(data, names):
    """A header above PIL's pixel limit is refused before any inflation;
    image data that inflates past its header's size is refused after
    inflating one byte past it."""
    with pytest.raises(ValueError, match=names):
        decode_png(data)


def test_png_reader_refuses_other_formats():
    img = Image.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P")
    buf = io.BytesIO()
    img.save(buf, "PNG")
    with pytest.raises(ValueError, match="palette"):
        decode_png(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(buf, "JPEG")
    with pytest.raises(ValueError, match="JPEG"):
        decode_png(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, "PNG")
    with pytest.raises(ValueError, match="16-bit"):
        decode_png(buf.getvalue())


# -- the CLI ----------------------------------------------------------------


def test_cli_tiny_cpu_serves():
    """``python -m mquant_tpu_torch.serve.server --tiny --device cpu --port
    0`` answers /health and one id completion."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "mquant_tpu_torch.serve.server", "--tiny",
         "--device", "cpu", "--port", "0"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        port = int(re.search(r"http://127\.0\.0\.1:(\d+)", line).group(1))
        st, body = _get(port, "/health")
        assert st == 200 and json.loads(body)["status"] == "ok"
        st, out = _post(port, "/v1/completions",
                        {"prompt": [1, 2, 3], "max_tokens": 4})
        assert st == 200 and len(out["choices"][0]["tokens"]) == 4
    finally:
        proc.kill()
        proc.communicate(timeout=30)


def test_registry_tiny_and_init_fn():
    """The family's ``tiny_fn`` / ``init_fn`` (the CLI's ``--tiny``): a CPU
    generator's draws, moved to the device asked for, as
    ``init_qwen2vl_params`` draws them."""
    from mquant_tpu_torch.models.qwen2vl import (Qwen2VLConfig,
                                                 init_qwen2vl_params)
    from mquant_tpu_torch.models.registry import get_family

    fam = get_family("Qwen2-VL-7B")
    cfg = fam.tiny_fn()
    assert cfg == Qwen2VLConfig.tiny()
    got = fam.init_fn(cfg, torch.Generator().manual_seed(3), device="cpu")
    want = init_qwen2vl_params(cfg, torch.Generator().manual_seed(3),
                               device="cpu")
    assert torch.equal(got["llm"]["layers"]["q"]["w"],
                       want["llm"]["layers"]["q"]["w"])
    assert torch.equal(got["vit"]["blocks"]["fc1"]["w"],
                       want["vit"]["blocks"]["fc1"]["w"])


def test_tokenizer_dir_needs_transformers(monkeypatch):
    from mquant_tpu_torch.serve import server

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(SystemExit, match="transformers"):
        server._load_tokenizer("/nonexistent")


def test_vlm_prefix_hit_outputs_exact(vlm_pair):
    """Embeds (image) requests match a registered text prefix through
    their ``draft_ids``: two hits, outputs equal to the runner's engine
    without the prefix and to JAX's runner with it."""
    from mquant_tpu.serve.engine import ServingEngine as JE

    jr, tr = vlm_pair[0].vlm_runner, vlm_pair[1].vlm_runner
    img = (np.random.default_rng(0).random((24, 24, 3)) * 255).astype(
        np.uint8)
    prompts = [{"text": "what is this?", "image": img},
               {"text": "describe the scene", "image": img}]
    base = tr.serve_engine(prompts, max_new_tokens=6)
    toks, _ = tr.build_inputs(prompts[0])
    ids = toks[0].tolist()
    first_img = ids.index(tr.cfg.image_token_id)
    assert first_img > 4  # the template has a text prefix
    prefix = ids[:first_img]
    outs = []
    for runner, E in ((tr, TEngine), (jr, JE)):
        eng = E(runner.cfg.llm, runner.params["llm"], specs=runner.specs,
                state=runner.state, mode=runner.mode, slots=2, max_len=512,
                steps_per_block=4, eos_id=0)
        eng.register_prefix(prefix)
        outs.append(runner.serve_engine(prompts, max_new_tokens=6,
                                        engine=eng))
        assert eng.prefix_hits == 2
    assert outs[0] == outs[1] == base
