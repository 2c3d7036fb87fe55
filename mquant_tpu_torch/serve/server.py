"""HTTP serving front end: an OpenAI-style API over the continuous-batching
engine (counterpart of ``mquant_tpu/serve/server.py``), and the deploy path
from an artifact directory.

One scheduler thread owns the :class:`~mquant_tpu_torch.serve.engine.
ServingEngine`: every call on the card, every CUDA-graph capture and the
kernels' first build happen there. HTTP handler threads submit requests,
block on per-request events and touch only host data; streaming responses
relay tokens at decode-block boundaries (``steps_per_block`` tokens per SSE
chunk).

Endpoints (JSON bodies, stdlib only):

- ``POST /v1/completions`` — {"prompt": "text" | [ids], "max_tokens": N,
  "stream": bool, "n", "stop", "logprobs", "seed", "temperature",
  "top_p", "presence_penalty", "frequency_penalty"}. Text prompts need a
  tokenizer (``encode`` / ``decode``); id prompts work bare and return
  ``{"tokens": [...]}``.
- ``POST /v1/chat/completions`` — {"messages": [...]}, rendered through the
  family chat template (``serve.chat``); OpenAI-vision ``image_url`` parts
  (base64 PNG, read by ``utils.png``) go through the VLM runner.
- ``GET /v1/models`` · ``GET /health`` · ``GET /metrics`` (Prometheus text).

``python -m mquant_tpu_torch.serve.server --artifact DIR`` serves an
artifact of the JAX pipeline or of the port's (``--tiny`` a random-weight
tiny model of ``--model``'s family); on the card unless ``--device`` says
otherwise.

Tensor parallel (``mesh=``, ``parallel.sharding``): every rank holds its
shard of the model and its own engine; rank 0 (tp index 0) runs HTTP and
the scheduler thread, which enters the mesh. At each block boundary it
broadcasts what its handlers received (token ids, image arrays, sampling
parameters and seeds, cancellations) as one tick, and every rank makes the
same engine calls from it: the other ranks run :func:`serve_follower`, which
serves no HTTP. Launch with ``--tp N``: the command spawns N ranks
(``torch.multiprocessing``, spawn), each calling ``init_process_group``
over a file store with gloo on the CPU, NCCL on the card (one card a rank,
``cuda:<rank>``); under ``torchrun --nproc_per_node N`` (RANK, WORLD_SIZE
and MASTER_ADDR set) each process joins from the environment instead. Two
ranks sharing one card take gloo (NCCL refuses two ranks on one device):
``chip_smoke.py --phase tp``. The NCCL launch, a card a rank, has not yet
run on a machine with several cards (ROADMAP A14a).

A crash of rank 0's scheduler fails its waiters and sends the other ranks
the stop tick, so they return; the HTTP front answers errors from then on,
as without a mesh.
"""

from __future__ import annotations

import base64
import binascii
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import torch

from ..utils.png import decode_png
from .engine import ServingEngine


class _Pending:
    """One in-flight request as seen by an HTTP handler thread. ``op`` is
    what the scheduler thread applies to the engine (:func:`_apply_op`):
    ("submit", kwargs), ("vlm", prompt, kwargs), whose vision pass and
    splice run there, off the handler threads, or ("call", fn)."""

    def __init__(self, op: tuple):
        self.op = op
        self.rid: Optional[int] = None
        self.done = threading.Event()
        self.tokens: List[int] = []
        self.error: Optional[str] = None
        # streaming: worker appends per-block deltas; handler drains
        self.deltas: "queue.Queue[Optional[List[int]]]" = queue.Queue()
        self._sent = 0  # tokens already pushed as deltas
        self.cancelled = False  # set by handler (client gone); worker acts
        self.lps: List[float] = []  # per-token logprobs (set at finish)
        self.stop: List[str] = []  # stop strings (checked per block)
        self.stop_text: Optional[str] = None  # text truncated at the stop
        self.t_submit = time.time()
        self.t_first: Optional[float] = None  # first token visible (TTFT)
        self.t_done: Optional[float] = None
        self.result: Any = None  # a call's return value
        self.exc: Optional[BaseException] = None

    def cancel(self):
        """Handler-side: request abort (e.g. the streaming client hung up).
        The worker thread performs the actual engine cancellation."""
        self.cancelled = True

    def fail(self, msg: str, exc: Optional[BaseException] = None):
        self.error, self.exc = msg, exc or RuntimeError(msg)
        self.deltas.put(None)
        self.done.set()

    def push_progress(self, out: List[int], final: bool):
        if out and self.t_first is None:
            self.t_first = time.time()
        if len(out) > self._sent:
            self.deltas.put(out[self._sent:])
            self._sent = len(out)
        if final:
            self.tokens = out
            self.t_done = time.time()
            self.deltas.put(None)  # stream sentinel
            self.done.set()


class EngineWorker:
    """Owns the engine; the only thread that touches its tensors (every
    call on the card, every CUDA-graph capture and the kernels' first
    build happen here).

    submit() is thread-safe and returns a :class:`_Pending`; the worker
    admits queued submissions at block boundaries (the engine's own
    continuous-batching semantics) and resolves them when they retire.
    """

    def __init__(self, engine: ServingEngine, poll_s: float = 0.005,
                 decode=None, mesh=None, runner=None):
        # under a tensor-parallel mesh the scheduler thread enters it and
        # keeps the other ranks (serve_follower) in step, tick by tick
        from ..parallel.sharding import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.sharding.Mesh, got "
                            f"{type(mesh).__name__}")
        if mesh is not None and mesh.tp > 1 and not mesh.tp_ranks:
            raise ValueError("a tensor-parallel mesh needs its process "
                             "groups: make it with parallel.sharding."
                             "make_mesh")
        self.mesh = mesh if mesh is not None and mesh.tp > 1 else None
        self.runner = runner  # the VLMRunner of ("vlm", ...) requests
        self.engine = engine
        self.poll_s = poll_s
        self.decode = decode  # tokens → text, needed for stop strings
        self._inbox: "queue.Queue[_Pending]" = queue.Queue()
        self._inflight: Dict[int, _Pending] = {}
        self._ticking: List[_Pending] = []  # the current tick's waiters
        self._wake = threading.Event()
        self._stop = False
        self.requests_total = 0
        self.tokens_total = 0
        self.cancelled_total = 0
        # running sums for /metrics (Prometheus summary convention)
        self.ttft_seconds_sum = 0.0
        self.ttft_count = 0
        self.request_seconds_sum = 0.0
        self.request_count = 0
        self.started = time.time()
        self.crashed: Optional[str] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mquant-engine-worker")
        self._thread.start()

    # -- handler-thread API --------------------------------------------------

    def _put(self, op: tuple, stop: Optional[List[str]] = None) -> _Pending:
        p = _Pending(op)
        p.stop = stop or []
        if self.crashed:
            p.fail(self.crashed)
            return p
        self._inbox.put(p)
        self._wake.set()
        return p

    def submit(self, tokens_or_embeds, max_new_tokens: int = 32,
               stop: Optional[List[str]] = None, **kw) -> _Pending:
        return self._put(("submit", dict(tokens_or_embeds=tokens_or_embeds,
                                         max_new_tokens=max_new_tokens,
                                         **kw)), stop)

    def submit_vlm(self, prompt, stop: Optional[List[str]] = None,
                   **kw) -> _Pending:
        """Queue an image prompt: the runner's vision pass and splice
        (``engine_request``) run on the scheduler thread, then the engine
        admits it with ``kw`` (max_new_tokens, sampling, seed)."""
        return self._put(("vlm", prompt, kw), stop)

    def call(self, fn, timeout: Optional[float] = None):
        """Run ``fn(engine)`` on the scheduler thread between two ticks and
        return its result (or raise its exception): how another thread
        touches the engine (registering a prefix, reading its tensors).
        Under a mesh every rank runs ``fn``, so it must pickle (a module
        function or a ``functools.partial``)."""
        p = self._put(("call", fn))
        if not p.done.wait(timeout):
            raise TimeoutError("engine worker call timed out")
        if p.error is not None:
            raise p.exc
        return p.result

    def shutdown(self, timeout: float = 10.0):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout)

    def stats(self) -> Dict[str, Any]:
        s = self.engine.stats()
        s.update(requests_total=self.requests_total,
                 tokens_total=self.tokens_total,
                 cancelled_total=self.cancelled_total,
                 ttft_seconds_sum=self.ttft_seconds_sum,
                 ttft_count=self.ttft_count,
                 request_seconds_sum=self.request_seconds_sum,
                 request_count=self.request_count,
                 uptime_s=time.time() - self.started,
                 inflight=len(self._inflight))
        return s

    def _check_stop(self, p: "_Pending") -> bool:
        """Stop-string scan (per block, host-side): decode the tokens so far
        and truncate at the first stop match. Needs a decode fn; granularity
        is the fused block, so a few post-stop tokens may have been decoded
        (and are trimmed from the text)."""
        if self.decode is None or p.rid is None:
            return False
        text = self.decode(self.engine.partial_output(p.rid))
        cut = min((i for i in (text.find(s) for s in p.stop) if i >= 0),
                  default=-1)
        if cut < 0:
            return False
        p.stop_text = text[:cut]
        return True

    def _finish(self, p: "_Pending", toks: List[int]):
        if p.rid is not None:
            p.lps = self.engine.logprobs_of(p.rid)[:len(toks)]
        self.tokens_total += len(toks)
        self.request_count += 1
        self.request_seconds_sum += time.time() - p.t_submit
        if p.t_first is not None:
            self.ttft_count += 1
            self.ttft_seconds_sum += p.t_first - p.t_submit
        p.push_progress(toks, final=True)

    # -- the scheduler thread -------------------------------------------------

    def _loop(self):
        from ..parallel.sharding import set_mesh

        try:
            with torch.no_grad(), set_mesh(self.mesh):
                while self._tick():
                    pass
            msg = "engine worker stopped"
        except Exception as e:  # noqa: BLE001 — fail every waiter, not hang
            import traceback

            traceback.print_exc()
            msg = self.crashed = f"engine worker crashed: {e}"
        waiters = self._ticking + list(self._inflight.values())
        self._inflight.clear()
        while True:
            try:
                waiters.append(self._inbox.get_nowait())
            except queue.Empty:
                break
        for p in waiters:
            if not p.done.is_set():
                p.fail(msg)
        if self.crashed and self.mesh is not None:
            self._stop_followers()

    def _tick(self) -> bool:
        """One scheduler tick. Gather what the handlers queued, the
        cancellations and the stop-string hits as ops; broadcast them (under
        a mesh: the other ranks apply the same ops, :func:`serve_follower`);
        apply them and step one block (:func:`_run_tick`); then answer the
        waiters, which only this rank has. False once stopped."""
        from ..parallel.collectives import broadcast_object

        if not self._stop and not self._inflight and self._inbox.empty():
            self._wake.wait(timeout=0.25)
            self._wake.clear()
        stop = self._stop
        ops: List[tuple] = []
        self._ticking = []
        while not stop:
            try:
                p = self._inbox.get_nowait()
            except queue.Empty:
                break
            ops.append(p.op)
            self._ticking.append(p)
        # handler-requested cancellations (client disconnects) and stop-
        # string hits, so the freed slots admit queued work this very tick
        for rid, p in ([] if stop else list(self._inflight.items())):
            if p.cancelled or (bool(p.stop) and self._check_stop(p)):
                ops.append(("cancel", rid))
                self._ticking.append(p)
        step = not stop and (bool(self._inflight)
                             or any(o[0] != "call" for o in ops))
        tick = broadcast_object({"ops": ops, "step": step, "stop": stop},
                                self.mesh)
        results, finished = _run_tick(self.engine, self.runner, tick)
        # from here on this rank's own bookkeeping: the other ranks of a
        # mesh already wait at the next tick's broadcast
        for op, p, res in zip(ops, self._ticking, results):
            self._resolve(op, p, res)
        self._ticking = []
        for rid, toks in finished.items():
            p = self._inflight.pop(rid, None)
            if p is not None:
                self._finish(p, toks)
            self.engine.release(rid)
        for rid, p in self._inflight.items():
            p.push_progress(self.engine.partial_output(rid), final=False)
        if step:
            # a tiny yield so handler threads get the GIL between blocks
            time.sleep(self.poll_s)
        return not stop

    def _resolve(self, op, p: "_Pending", res):
        """The waiter's side of one applied op."""
        if op[0] == "cancel":
            rid = op[1]
            if p.cancelled:
                self.cancelled_total += 1
            self._inflight.pop(rid, None)
            self._finish(p, self.engine.partial_output(rid))
            self.engine.release(rid)
        elif isinstance(res, Exception):  # surfaced as HTTP 400 / re-raised
            p.fail(str(res), res)
        elif op[0] == "call":
            p.result = res
            p.done.set()
        else:
            p.rid = res
            self._inflight[res] = p
            self.requests_total += 1

    def _stop_followers(self):
        """After a crash, the stop tick, so that the other ranks return from
        :func:`serve_follower`. A crash in this rank's own bookkeeping finds
        them waiting at the next tick's broadcast; a fault inside the
        engine's step on this rank alone leaves them in a collective of the
        forward, which the stop tick cannot reach (they wait for the
        collective's timeout)."""
        from ..parallel.collectives import broadcast_object

        try:
            broadcast_object({"ops": [], "step": False, "stop": True},
                             self.mesh)
        except Exception:  # noqa: BLE001 — the waiters already failed
            import traceback

            traceback.print_exc()


def _apply_op(engine: ServingEngine, runner, op):
    """One op of a tick on this rank's engine: ("submit", kwargs), ("vlm",
    prompt, kwargs) (the runner's vision pass and splice on this rank, then
    submit), ("call", fn) or ("cancel", rid). Returns the submission's rid
    or the call's result."""
    kind = op[0]
    if kind == "submit":
        return engine.submit(**op[1])
    if kind == "vlm":
        kw = runner.engine_request(op[1])
        kw.update(op[2])
        return engine.submit(**kw)
    if kind == "call":
        return op[1](engine)
    if kind == "cancel":
        return engine.cancel(op[1])
    raise ValueError(f"unknown tick op {kind!r}")


def _run_tick(engine: ServingEngine, runner, tick) -> tuple:
    """Every rank's share of one tick: the ops in order, an op's exception
    being its result (every rank meets the same one: the same inputs on the
    same code), then one block if the tick steps. Returns (the ops'
    results, the requests that finished)."""
    results = []
    for op in tick["ops"]:
        try:
            results.append(_apply_op(engine, runner, op))
        except Exception as e:  # noqa: BLE001 — the waiter's error
            results.append(e)
    return results, (engine.step_block() if tick["step"] else {})


@torch.no_grad()
def serve_follower(engine: ServingEngine, mesh, runner=None) -> None:
    """A tensor-parallel rank other than 0: receive rank 0's ticks and make
    the same engine calls (the vision passes through ``runner``), until the
    tick that says stop. Serves no HTTP."""
    from ..parallel.collectives import broadcast_object
    from ..parallel.sharding import set_mesh

    with set_mesh(mesh):
        while True:
            tick = broadcast_object(None, mesh)
            _, finished = _run_tick(engine, runner, tick)
            for op in tick["ops"]:
                if op[0] == "cancel":
                    engine.release(op[1])
            for rid in finished:
                engine.release(rid)
            if tick["stop"]:
                return


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------


def _prometheus(stats: Dict[str, Any]) -> str:
    lines = []
    for k, v in stats.items():
        if isinstance(v, bool):
            v = int(v)
        if isinstance(v, (int, float)) and v == v:  # drop NaNs
            lines.append(f"mquant_{k} {v}")
    return "\n".join(lines) + "\n"


class InferenceServer:
    """Bundle of worker + tokenizer + HTTP server.

    ``tokenizer``: optional object with ``encode(str) -> List[int]`` and
    ``decode(List[int]) -> str``. Without one, only integer-id prompts are
    accepted and responses carry raw token ids.
    ``chat_family``: family name for serve/chat.py templates (text-only
    messages; VLM image traffic goes through VLMRunner.serve_engine, which
    feeds the same engine programmatically).
    """

    def __init__(self, engine: ServingEngine, tokenizer=None,
                 chat_family: str = "qwen2vl", model_name: str = "mquant-tpu",
                 host: str = "127.0.0.1", port: int = 0, vlm_runner=None,
                 mesh=None):
        """``mesh``: this rank's tensor-parallel mesh (tp index 0: the
        other ranks run :func:`serve_follower` on their engines)."""
        self.tokenizer = tokenizer
        # a VLMRunner enables OpenAI-vision-style image parts in chat
        # messages: the handler thread decodes base64 → array (CPU), the
        # scheduler thread runs vision encode + splice (device) via
        # engine_request, then the spliced embeds join the same slot pool
        self.vlm_runner = vlm_runner
        if vlm_runner is not None and tokenizer is None:
            self.tokenizer = vlm_runner.tok
        self.worker = EngineWorker(
            engine, decode=(self.tokenizer.decode
                            if self.tokenizer is not None else None),
            mesh=mesh, runner=vlm_runner)
        self.chat_family = chat_family
        self.model_name = model_name
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet by default
                pass

            # -- helpers ------------------------------------------------------
            def _json(self, code: int, obj: Dict[str, Any]):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> Dict[str, Any]:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            # -- routes -------------------------------------------------------
            def do_GET(self):
                if self.path == "/health":
                    self._json(200, {"status": "ok"})
                elif self.path == "/v1/models":
                    self._json(200, {"object": "list", "data": [
                        {"id": server.model_name, "object": "model"}]})
                elif self.path == "/metrics":
                    body = _prometheus(server.worker.stats()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                try:
                    req = self._body()
                except (ValueError, json.JSONDecodeError):
                    return self._json(400, {"error": "invalid JSON"})
                if self.path == "/v1/completions":
                    return self._generate(req, chat=False)
                if self.path == "/v1/chat/completions":
                    return self._generate(req, chat=True)
                self._json(404, {"error": "not found"})

            def _generate(self, req: Dict[str, Any], chat: bool):
                max_tokens = int(req.get("max_tokens", 32))
                sample_kw = dict(
                    temperature=float(req.get("temperature", 0.0)),
                    top_p=float(req.get("top_p", 1.0)),
                    presence_penalty=float(req.get("presence_penalty", 0.0)),
                    frequency_penalty=float(req.get("frequency_penalty",
                                                    0.0)))
                req_seed = req.get("seed")
                stop = req.get("stop") or []
                if isinstance(stop, str):
                    stop = [stop]
                n = int(req.get("n", 1))
                if not 1 <= n <= 8:
                    return self._json(400, {"error": "n must be in [1, 8]"})
                if n > 1 and req.get("stream"):
                    return self._json(
                        400, {"error": "streaming supports n=1 only"})
                if n > 1 and sample_kw["temperature"] <= 0:
                    return self._json(
                        400, {"error": "n > 1 needs temperature > 0 "
                                       "(greedy copies are identical)"})
                try:
                    if chat and server._has_image(req):
                        prompt = server._vlm_prompt(req)
                        # n > 1 re-runs the vision tower per copy — simple
                        # and correct; the tower is a small fraction of an
                        # n-way sampled decode. n copies under an explicit
                        # seed get seed+i: identical noise would defeat n > 1
                        pendings = [server.worker.submit_vlm(
                            prompt, stop=stop, max_new_tokens=max_tokens,
                            **(dict(sample_kw, seed=int(req_seed) + i)
                               if req_seed is not None else sample_kw))
                            for i in range(n)]
                    else:
                        ids = server._prompt_ids(req, chat)
                        pendings = [server.worker.submit(
                            ids, max_new_tokens=max_tokens, stop=stop,
                            **(dict(sample_kw, seed=int(req_seed) + i)
                               if req_seed is not None else sample_kw))
                            for i in range(n)]
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                if req.get("stream"):
                    return self._stream(pendings[0], chat)
                for pending in pendings:
                    pending.done.wait()
                errs = [p.error for p in pendings if p.error]
                if errs:
                    return self._json(400, {"error": errs[0]})
                self._json(200, server._response_n(
                    pendings, chat, logprobs=bool(req.get("logprobs"))))

            def _stream(self, pending: "_Pending", chat: bool):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                import select
                import socket as _socket

                def gone() -> bool:
                    # a streaming client sends nothing more; readability
                    # means EOF (clean close) or RST — either way it's gone.
                    # Writes into a dead localhost socket can succeed for
                    # the whole response, so poll the read side instead.
                    r, _, _ = select.select([self.connection], [], [], 0)
                    if not r:
                        return False
                    try:
                        return not self.connection.recv(1, _socket.MSG_PEEK)
                    except OSError:
                        return True

                def chunk(data: str):
                    if gone():
                        raise BrokenPipeError("client disconnected")
                    payload = f"data: {data}\n\n".encode()
                    self.wfile.write(hex(len(payload))[2:].encode()
                                     + b"\r\n" + payload + b"\r\n")
                    self.wfile.flush()

                try:
                    while True:
                        delta = pending.deltas.get()
                        if delta is None:
                            break
                        chunk(json.dumps(server._delta(delta, chat)))
                    if pending.error:
                        chunk(json.dumps({"error": pending.error}))
                    chunk("[DONE]")
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    # client hung up mid-stream: stop decoding for this
                    # request so its slot serves someone else
                    pending.cancel()

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="mquant-http")
        self._http_thread.start()

    @classmethod
    def for_vlm(cls, runner, slots: int = 4, max_len: int = 512,
                model_name: str = "mquant-tpu", host: str = "127.0.0.1",
                port: int = 0, mesh=None, **engine_kw):
        """Build a server around a :class:`VLMRunner`: the engine inherits
        the runner's quantization state (specs/state/mode), text requests
        tokenize through the runner's tokenizer, and image requests go
        through its vision tower. ``mesh``: as in :class:`InferenceServer`
        (the runner holds this rank's shard)."""
        return cls(runner.new_engine(slots, max_len, **engine_kw),
                   tokenizer=runner.tok, chat_family=runner.fam.name,
                   model_name=model_name, host=host, port=port,
                   vlm_runner=runner, mesh=mesh)

    # -- request/response shaping --------------------------------------------

    @staticmethod
    def _has_image(req: Dict[str, Any]) -> bool:
        for m in req.get("messages") or []:
            c = m.get("content")
            if isinstance(c, list) and any(
                    isinstance(p, dict) and p.get("type") == "image_url"
                    for p in c):
                return True
        return False

    def _vlm_prompt(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """OpenAI-vision messages → VLMRunner prompt dict. The runner applies
        the family chat template itself (build_inputs), so only raw question
        text + decoded image arrays are extracted here."""
        if self.vlm_runner is None:
            raise ValueError("image content requires a VLM-configured server")

        msgs = req.get("messages") or []
        system = "\n".join(m.get("content", "") for m in msgs
                           if m.get("role") == "system"
                           and isinstance(m.get("content"), str)) or None
        # EVERY earlier turn becomes real chat history ((q, a) pairs,
        # rendered as per-turn markup by the runner's template — ref
        # make_context parity); list-content turns contribute their text
        # parts. Only the FINAL turn may carry images (the runner embeds
        # image features into the final user turn only) — an image in an
        # earlier turn is rejected loudly instead of being silently merged
        # into the final question.
        history: List[Any] = []
        pending_q: Any = None
        body = [m for m in msgs if m.get("role") != "system"]
        last = len(body) - 1
        texts: List[str] = []
        images: List[Any] = []

        def parts_text(c):
            if isinstance(c, str):
                return c
            return "\n".join(p.get("text", "") for p in c or []
                             if p.get("type") == "text")

        for i, m in enumerate(body):
            c = m.get("content")
            if i < last:
                if not isinstance(c, str) and any(
                        p.get("type") == "image_url" for p in c or []):
                    raise ValueError(
                        "images are only supported in the final user turn; "
                        "earlier turns join the text history")
                if m.get("role") == "assistant":
                    history.append((pending_q or "", parts_text(c)))
                    pending_q = None
                else:
                    if pending_q is not None:
                        history.append((pending_q, None))
                    pending_q = parts_text(c)
                continue
            if isinstance(c, str):
                texts.append(c)
                continue
            for part in c or []:
                if part.get("type") == "text":
                    texts.append(part.get("text", ""))
                elif part.get("type") == "image_url":
                    url = (part.get("image_url") or {}).get("url", "")
                    b64 = url.split(",", 1)[1] if url.startswith("data:") else url
                    try:
                        images.append(decode_png(
                            base64.b64decode(b64, validate=True)))
                    except (ValueError, binascii.Error) as e:
                        raise ValueError(f"bad image: {e}") from e
        if pending_q is not None:
            history.append((pending_q, None))
        if not texts and not images:
            raise ValueError("no user content")
        prompt: Dict[str, Any] = {"text": "\n".join(t for t in texts if t)}
        if system:
            prompt["system"] = system
        if history:
            prompt["history"] = history
        if images:
            prompt["image"] = images if len(images) > 1 else images[0]
        return prompt

    def _prompt_ids(self, req: Dict[str, Any], chat: bool) -> List[int]:
        if chat:
            msgs = req.get("messages")
            if not isinstance(msgs, list) or not msgs:
                raise ValueError("messages required")
            text = self._render_chat(msgs)
            if self.tokenizer is None:
                raise ValueError("chat endpoint requires a tokenizer")
            return list(self.tokenizer.encode(text))
        prompt = req.get("prompt")
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("text prompt requires a tokenizer; "
                                 "send token ids instead")
            return list(self.tokenizer.encode(prompt))
        if isinstance(prompt, list) and all(isinstance(t, int) for t in prompt):
            if not prompt:
                raise ValueError("empty prompt")
            return prompt
        raise ValueError("prompt must be a string or a list of token ids")

    def _render_chat(self, msgs: List[Dict[str, Any]]) -> str:
        from .chat import build_chat_prompt

        def text_of(m):
            c = m.get("content", "")
            if isinstance(c, list):  # content-part arrays without images
                return "\n".join(p.get("text", "") for p in c
                                 if isinstance(p, dict)
                                 and p.get("type") == "text")
            return c

        system = "\n".join(text_of(m) for m in msgs
                           if m.get("role") == "system") or None
        turns = [m for m in msgs if m.get("role") != "system"]
        if not turns:
            raise ValueError("no user message")
        # multi-turn: every history turn rendered as REAL per-turn chat markup
        # with newest-first window truncation (ref make_context parity,
        # model/qwen_generation_utils.py:128-171) — not role-prefixed prose
        history = []
        pending_q = None
        for m in turns[:-1]:
            if m.get("role") == "assistant":
                history.append((pending_q or "", text_of(m)))
                pending_q = None
            else:
                if pending_q is not None:  # consecutive user turns: a=None
                    history.append((pending_q, None))
                pending_q = text_of(m)
        if pending_q is not None:
            history.append((pending_q, None))
        question = text_of(turns[-1])
        encode = (self.tokenizer.encode if self.tokenizer is not None
                  else None)
        pieces = build_chat_prompt(self.chat_family, question,
                                   n_image_tokens=0, system=system,
                                   history=history, encode=encode)
        return pieces["text_before"] + pieces["text_after"]

    def _response_n(self, pendings, chat: bool,
                    logprobs: bool = False) -> Dict[str, Any]:
        """Merge n completions into one OpenAI-style response."""
        out = self._response(pendings[0], chat, logprobs=logprobs)
        for i, p in enumerate(pendings[1:], start=1):
            extra = self._response(p, chat, logprobs=logprobs)
            c = extra["choices"][0]
            c["index"] = i
            out["choices"].append(c)
            out["usage"]["completion_tokens"] += len(p.tokens)
        return out

    def _response(self, pending, chat: bool,
                  logprobs: bool = False) -> Dict[str, Any]:
        tokens = pending.tokens
        out: Dict[str, Any] = {"model": self.model_name,
                               "usage": {"completion_tokens": len(tokens)}}
        text = (self.tokenizer.decode(tokens)
                if self.tokenizer is not None else None)
        reason = "length"
        if pending.stop_text is not None:  # stop-string hit: truncated text
            text, reason = pending.stop_text, "stop"
        if chat:
            out["object"] = "chat.completion"
            out["choices"] = [{"index": 0, "finish_reason": reason,
                               "message": {"role": "assistant",
                                           "content": text},
                               "tokens": tokens}]
        else:
            out["object"] = "text_completion"
            out["choices"] = [{"index": 0, "finish_reason": reason,
                               "text": text, "tokens": tokens}]
        if logprobs:
            out["choices"][0]["logprobs"] = {
                "token_logprobs": [round(v, 6) for v in pending.lps]}
        return out

    def _delta(self, tokens: List[int], chat: bool) -> Dict[str, Any]:
        text = (self.tokenizer.decode(tokens)
                if self.tokenizer is not None else None)
        if chat:
            return {"object": "chat.completion.chunk",
                    "choices": [{"index": 0,
                                 "delta": {"content": text},
                                 "tokens": tokens}]}
        return {"object": "text_completion.chunk",
                "choices": [{"index": 0, "text": text, "tokens": tokens}]}

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.worker.shutdown()


# ---------------------------------------------------------------------------
# deploy path: artifact directory → runner → running server
# ---------------------------------------------------------------------------


def build_runner_from_artifact(artifact_dir: str, mode: Optional[str] = None,
                               tokenizer=None, max_len: int = 512,
                               device="cuda",
                               image_size: Optional[int] = None,
                               pad_to_max: bool = False, mesh=None):
    """Artifact → ``VLMRunner`` on ``device`` (the card unless the caller
    asks for another). ``mode`` defaults to "real" where the pipeline
    realized int storage (its ``quantize_config.realize_int``), else
    "fake". ``image_size`` is the runner's base bucket side (default 4
    patches); ``pad_to_max`` pads every image's patch sequence to the
    largest bucket's, with its validity mask. ``mesh``: the runner holds
    this tensor-parallel rank's shard (``parallel.sharding``)."""
    from ..evaluation.adapter import VLMRunner
    from ..utils.checkpoint import config_from_dict, load_artifact

    params, state, specs, meta = load_artifact(artifact_dir, device=device)
    if "config_dict" not in meta:
        raise ValueError(f"artifact at {artifact_dir} predates config_dict "
                         "meta; re-export with run_pipeline")
    cfg = config_from_dict(meta["config_dict"])
    if mesh is not None:
        cfg, params = _shard(cfg, params, mesh)
    if mode is None:
        mode = ("real" if (meta.get("quantize_config") or {}).get(
            "realize_int") else "fake")
    return VLMRunner(meta["model"], cfg, params, specs=specs, state=state,
                     mode=mode, tokenizer=tokenizer, max_len=max_len,
                     image_size=image_size, pad_to_max=pad_to_max)


def build_server_from_artifact(artifact_dir: str, mode: Optional[str] = None,
                               tokenizer=None, slots: int = 4,
                               max_len: int = 512, port: int = 0,
                               host: str = "127.0.0.1", device="cuda",
                               image_size: Optional[int] = None,
                               **engine_kw) -> InferenceServer:
    """Quantize once, serve from the artifact: the runner of
    :func:`build_runner_from_artifact` behind :meth:`InferenceServer.
    for_vlm` (its engine shares the runner's packed W4 weights)."""
    runner = build_runner_from_artifact(artifact_dir, mode=mode,
                                        tokenizer=tokenizer, max_len=max_len,
                                        device=device, image_size=image_size)
    return InferenceServer.for_vlm(
        runner, slots=slots, max_len=max_len, host=host, port=port,
        model_name=runner.fam.name, **engine_kw)


def _shard(cfg, params, mesh):
    """(local config, this rank's params) of a family's model."""
    from ..parallel.sharding import local_config, shard_params

    return local_config(cfg, mesh), shard_params(params, mesh, cfg=cfg)


def _load_tokenizer(path: str):
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise SystemExit(f"--tokenizer_dir needs the transformers package, "
                         f"which is not installed ({e}); send token ids "
                         "instead") from e
    return AutoTokenizer.from_pretrained(path, trust_remote_code=True)


def main(argv=None):
    """CLI: ``python -m mquant_tpu_torch.serve.server --artifact DIR --port
    8000`` (or ``--tiny`` for a random-weight tiny model of ``--model``'s
    family: qwen2vl, qwenvl, internvl, glm4v or minicpmv)."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--artifact", default=None,
                   help="quantization artifact dir (run_pipeline's, or "
                        "python -m mquant_tpu_torch.quant_vlm --artifact)")
    p.add_argument("--model", default="qwen2vl",
                   help="family for --tiny demo mode (qwen2vl, qwenvl, "
                        "internvl, glm4v, minicpmv)")
    p.add_argument("--tiny", action="store_true",
                   help="serve a tiny random-weight model (smoke/demo)")
    p.add_argument("--mode", default=None, choices=["fp", "fake", "real"])
    p.add_argument("--tokenizer_dir", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max_len", type=int, default=2048)
    p.add_argument("--kv_bits", type=int, default=None, choices=[4, 8],
                   help="quantized KV cache of the engine's pool (8: int8, "
                        "4: nibble-packed int4)")
    p.add_argument("--spec_k", type=int, default=0,
                   help="n-gram draft length of self-speculative rounds "
                        "(greedy only: the --spec_k 0 tokens in fewer "
                        "forwards)")
    p.add_argument("--steps_per_block", type=int, default=8)
    p.add_argument("--sample_top_k", type=int, default=64,
                   help="top-k cap for sampled requests (0 = greedy-only "
                        "engine; mutually exclusive with --spec_k)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks: spawned here (gloo on the "
                        "CPU, NCCL with one card a rank), or the torchrun "
                        "world when RANK / WORLD_SIZE are set")
    args = p.parse_args(argv)
    if args.spec_k:
        # sampling and speculation are mutually exclusive, as in the JAX
        # engine (ServingEngine raises on both)
        args.sample_top_k = 0
    if not (args.artifact or args.tiny):
        raise SystemExit("--artifact or --tiny required")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # under torchrun
        return _serve_rank(int(os.environ["RANK"]), args, None)
    if args.tp > 1:
        import tempfile

        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory() as store:
            mp.start_processes(_serve_rank, args=(args, store),
                               nprocs=args.tp, start_method="spawn")
        return
    _serve(args, args.device, None)


def _serve(args, device, mesh):
    """Build this rank's runner and engine and serve: HTTP on tp index 0
    (or without a mesh), :func:`serve_follower` on the other ranks."""
    tokenizer = (_load_tokenizer(args.tokenizer_dir) if args.tokenizer_dir
                 else None)
    engine_kw = dict(spec_k=args.spec_k,
                     steps_per_block=args.steps_per_block,
                     kv_quant=args.kv_bits or False,
                     sample_top_k=args.sample_top_k, seed=args.seed)
    if args.artifact:
        runner = build_runner_from_artifact(
            args.artifact, mode=args.mode, tokenizer=tokenizer,
            max_len=args.max_len, device=device, mesh=mesh)
    else:
        from ..evaluation.adapter import VLMRunner
        from ..models.registry import get_family

        fam = get_family(args.model)
        cfg = fam.tiny_fn()
        params = fam.init_fn(cfg, torch.Generator().manual_seed(0),
                             device=device)
        if mesh is not None:
            cfg, params = _shard(cfg, params, mesh)
        runner = VLMRunner(fam.name, cfg, params, tokenizer=tokenizer,
                           max_len=args.max_len, mode=args.mode or "fp")
    if mesh is not None and mesh.tp_index != 0:
        serve_follower(runner.new_engine(args.slots, args.max_len,
                                         **engine_kw), mesh, runner)
        return
    srv = InferenceServer.for_vlm(runner, slots=args.slots,
                                  max_len=args.max_len, host=args.host,
                                  port=args.port,
                                  model_name=(runner.fam.name if args.artifact
                                              else "mquant-tpu"),
                                  mesh=mesh, **engine_kw)
    print(f"serving {srv.model_name} on http://{args.host}:{srv.port} "
          f"(slots={args.slots}, max_len={args.max_len}, device={device}"
          f"{f', tp={mesh.tp}' if mesh else ''})", flush=True)
    try:
        srv._http_thread.join()
    except KeyboardInterrupt:
        srv.shutdown()


def _serve_rank(rank: int, args, store: Optional[str]):
    """One tensor-parallel rank of ``--tp``: its process group (a file
    store under ``store``, or torchrun's environment), its device, the
    mesh, then :func:`_serve`."""
    import torch.distributed as dist

    from ..parallel.sharding import make_mesh

    world = args.tp if store else int(os.environ["WORLD_SIZE"])
    backend = "gloo" if args.device == "cpu" else "nccl"
    device = args.device
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = f"cuda:{local}"
        torch.cuda.set_device(device)
    if store:
        dist.init_process_group(backend, init_method=f"file://{store}/pg",
                                rank=rank, world_size=world)
    else:
        dist.init_process_group(backend)
    try:
        _serve(args, device, make_mesh())
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
