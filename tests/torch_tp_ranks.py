"""Tensor-parallel ranks for the port's sharding tests: :func:`spawn` starts
``world`` processes (spawn context, one torch thread each, a gloo process
group over a file store), runs one job of this module in every rank and
returns rank 0's result. The jobs import no JAX: the test modules hand them
numpy inputs and hold their numpy outputs against the JAX package."""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np
import torch


def spawn(job: str, payload: Any, world: int, tmp_path) -> Any:
    """Run ``job(rank, world, payload)`` in ``world`` gloo ranks; returns
    rank 0's result. A rank that raises makes this raise."""
    import torch.multiprocessing as mp

    d = str(tmp_path)
    with open(os.path.join(d, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    mp.start_processes(_entry, args=(world, d, job), nprocs=world,
                       start_method="spawn")
    with open(os.path.join(d, "result.pkl"), "rb") as f:
        return pickle.load(f)


def _entry(rank: int, world: int, d: str, job: str):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(d, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        out = globals()[job](rank, world, payload)
        if rank == 0:
            with open(os.path.join(d, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def tree_to_torch(tree):
    """A numpy tree → CPU tensors; ("qp", scale, zp) tuples → QuantParams."""
    from mquant_tpu_torch.core.quant import QuantParams

    if isinstance(tree, dict):
        return {k: tree_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and tree and tree[0] == "qp":
        return QuantParams(torch.from_numpy(np.array(tree[1])),
                           None if tree[2] is None
                           else torch.from_numpy(np.array(tree[2])))
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def _np(t):
    return t.detach().float().numpy() if t.is_floating_point() \
        else t.detach().numpy()


def decoder_cfg(kw: Dict):
    from mquant_tpu_torch.models.llm import DecoderConfig

    return DecoderConfig(**{**kw, "dtype": torch.float32})


def w4_specs(had: str, split: bool):
    """The main path's serving specs (``random_init.llm_specs``)."""
    from mquant_tpu_torch import random_init as R

    return R.llm_specs(had, split=split)


def meshes():
    from mquant_tpu_torch.parallel.sharding import make_mesh

    return {4: make_mesh(tp=4), 2: make_mesh(tp=2)}


def sharded(cfg, params, mesh):
    from mquant_tpu_torch.parallel.sharding import local_config, shard_params

    return local_config(cfg, mesh), shard_params(params, mesh, cfg=cfg)


# ---------------------------------------------------------------------------
# forwards, families, GPTQ (tests/test_torch_sharding.py)
# ---------------------------------------------------------------------------


def forward_jobs(rank: int, world: int, pl: Dict) -> Dict:
    from mquant_tpu_torch.models.llm import decoder_forward, init_cache
    from mquant_tpu_torch.models.registry import get_family
    from mquant_tpu_torch.parallel.sharding import set_mesh
    from mquant_tpu_torch.serve.generate import Generator

    ms = meshes()
    out: Dict[str, Any] = {"mesh_shapes": {k: m.shape for k, m in ms.items()},
                           "mesh_index": {k: (m.dp_index, m.tp_index)
                                          for k, m in ms.items()}}

    # fp decoders at tp = 4: n_kv 4, and n_kv 2 (KV heads replicated)
    for name, d in pl["fp"].items():
        cfg, params = decoder_cfg(d["cfg"]), tree_to_torch(d["params"])
        toks = torch.from_numpy(d["toks"])
        lc, sp = sharded(cfg, params, ms[4])
        with set_mesh(ms[4]):
            out[f"fp/{name}"] = _np(decoder_forward(lc, sp, toks)[0])

    # W8A8 dynamic per-token scales at tp = 4: real, and fake
    d = pl["w8"]
    cfg, params = decoder_cfg(d["cfg"]), tree_to_torch(d["params"])
    toks = torch.from_numpy(d["toks"])
    specs = d["specs"]
    out["w8/solo"] = _np(decoder_forward(cfg, params, toks, specs=specs,
                                         mode="real")[0])
    lc, sp = sharded(cfg, params, ms[4])
    with set_mesh(ms[4]):
        out["w8/tp"] = _np(decoder_forward(lc, sp, toks, specs=specs,
                                           mode="real")[0])
    params = tree_to_torch(d["fparams"])
    out["w8fake/solo"] = _np(decoder_forward(cfg, params, toks, specs=specs,
                                             mode="fake")[0])
    lc, sp = sharded(cfg, params, ms[4])
    with set_mesh(ms[4]):
        out["w8fake/tp"] = _np(decoder_forward(lc, sp, toks, specs=specs,
                                               mode="fake")[0])

    # the main path's W4A8 static storage: block (with the RMS split), F
    # and S; logits at tp = 2 and 4 and greedy tokens
    for name, d in pl["w4"].items():
        cfg, params = decoder_cfg(d["cfg"]), tree_to_torch(d["params"])
        state = tree_to_torch(d["state"])
        specs = w4_specs(d["had"], d["split"])
        toks = torch.from_numpy(d["toks"])
        kw = dict(specs=specs, state=state, mode="real")
        out[f"w4/{name}/solo"] = _np(decoder_forward(cfg, params, toks,
                                                     **kw)[0])
        for tp in d["tps"]:
            lc, sp = sharded(cfg, params, ms[tp])
            with set_mesh(ms[tp]):
                out[f"w4/{name}/tp{tp}"] = _np(decoder_forward(lc, sp, toks,
                                                               **kw)[0])
                g = Generator(lc, sp, specs=specs, state=state, mode="real",
                              max_len=64)
                out[f"w4/{name}/tokens{tp}"] = _np(g.generate_on_device(
                    toks[:1], max_new_tokens=d["new"]))

    # prefill + 3 decode steps at tp = 4 (fp)
    d = pl["steps"]
    cfg, params = decoder_cfg(d["cfg"]), tree_to_torch(d["params"])
    toks = torch.from_numpy(d["toks"])
    lc, sp = sharded(cfg, params, ms[4])
    steps = []
    with set_mesh(ms[4]):
        cache = init_cache(lc, toks.shape[0], 16, device="cpu")
        logits, cache, _ = decoder_forward(lc, sp, toks, cache=cache,
                                           prefill_fresh=True)
        tok = logits[:, -1:].argmax(-1)
        for _ in range(3):
            logits, cache, _ = decoder_forward(lc, sp, tok, cache=cache)
            tok = logits[:, -1:].argmax(-1)
            steps.append(_np(tok))
    out["steps"] = steps

    # every family at tp = 2: fp logits, fake-mode finiteness
    for fname, d in pl["families"].items():
        fam = get_family(fname)
        cfg = fam.tiny_fn()
        params = tree_to_torch(d["params"])
        extra = tree_to_torch(d["extra"])
        toks = torch.from_numpy(d["tokens"])
        patches = torch.from_numpy(d["patches"])
        lc, sp = sharded(cfg, params, ms[2])
        with set_mesh(ms[2]):
            fp = fam.forward_fn(lc, sp, toks, patches, mode="fp", **extra)[0]
            fk = fam.forward_fn(lc, sp, toks, patches, specs=d["specs"],
                                mode="fake", **extra)[0]
        out[f"family/{fname}"] = _np(fp)
        out[f"family/{fname}/fake_finite"] = bool(torch.isfinite(fk).all())

    out.update(gptq_jobs(ms, pl["gptq"]))
    return out


def gptq_jobs(ms, d: Dict) -> Dict:
    """hessian_dp at (dp 2, tp 2); the sharded walk, with this package's H
    and with JAX's U fed in; realize under the mesh (4 ranks)."""
    from mquant_tpu_torch.gptq import core as C
    from mquant_tpu_torch.gptq import sharded as S
    from mquant_tpu_torch.parallel.sharding import shard_batch

    out = {}
    X, W = torch.from_numpy(d["X"]), torch.from_numpy(d["W"])
    m2 = ms[2]
    out["H_dp"] = _np(S.hessian_dp(shard_batch(X, m2), m2))
    H = C.accumulate_hessian(None, X)
    for i, case in enumerate(d["cases"]):
        kw = dict(bits=4, act_order=case["act_order"],
                  group_size=case["group_size"], sym=case["sym"])
        r = S.gptq_matrix_sharded(W, H, ms[4], **kw)
        solo = C.gptq_quantize_matrix(W, H, **kw)
        out[f"walk{i}"] = {k: None if v is None else _np(v) for k, v in
                           (("w", r.w), ("scale", r.scale), ("zero", r.zero),
                            ("perm", r.perm),
                            ("fallback", r.used_fallback))}
        out[f"solo{i}"] = {k: None if v is None else _np(v) for k, v in
                           (("w", solo.w), ("scale", solo.scale),
                            ("zero", solo.zero), ("perm", solo.perm))}
        # the walk on JAX's U, sharded
        Uj = torch.from_numpy(case["Uj"])
        perm = None if case["perm"] is None else torch.from_numpy(
            case["perm"])
        diag = torch.from_numpy(case["diag"])
        rj = S.walk_sharded(W, diag, Uj, perm, ms[4], bits=4,
                            group_size=case["group_size"], mse_clip=False,
                            sym=case["sym"])
        out[f"walkU{i}"] = {k: None if v is None else _np(v) for k, v in
                            (("w", rj.w), ("scale", rj.scale),
                             ("zero", rj.zero))}
    from mquant_tpu_torch.kernels.qmm import quantize_weights_real

    out["realize_solo"] = {k: _np(v) for k, v in
                           quantize_weights_real(W, 4, pack=True).items()}
    out["realize_tp"] = {k: _np(v) for k, v in
                         S.realize_sharded(W, 4, ms[4], pack=True).items()}
    return out


# ---------------------------------------------------------------------------
# serving (tests/test_torch_sharding_serving.py)
# ---------------------------------------------------------------------------


def _post(port: int, body: dict, path: str = "/v1/completions"):
    import http.client
    import json

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def _serve_all(engine, prompts, mesh=None, runner=None, chats=()):
    """Every prompt through a server's HTTP API (rank 0 of a mesh; the
    other ranks follow); returns the completions' tokens and the chat
    texts."""
    from mquant_tpu_torch.serve.server import InferenceServer, serve_follower

    if mesh is not None and mesh.tp_index != 0:
        serve_follower(engine, mesh, runner)
        return None
    srv = InferenceServer(engine, port=0, mesh=mesh, vlm_runner=runner)
    try:
        outs = []
        for p in prompts:
            status, out = _post(srv.port, {"prompt": p, "max_tokens": 5})
            assert status == 200, out
            outs.append(out["choices"][0]["tokens"])
        for body in chats:
            status, out = _post(srv.port, body, "/v1/chat/completions")
            assert status == 200, out
            outs.append(out["choices"][0]["message"]["content"])
        return outs
    finally:
        srv.shutdown()


def serving_jobs(rank: int, world: int, pl: Dict) -> Dict:
    from mquant_tpu_torch.parallel.sharding import set_mesh
    from mquant_tpu_torch.serve.engine import ServingEngine
    from mquant_tpu_torch.serve.generate import Generator
    from mquant_tpu_torch.serve.speculative import speculative_generate

    ms = meshes()
    m4 = ms[4]
    out: Dict[str, Any] = {}
    d = pl["fp"]
    cfg, params = decoder_cfg(d["cfg"]), tree_to_torch(d["params"])
    lc, sp = sharded(cfg, params, m4)
    prompts = d["prompts"]

    # the engine, with a registered prefix
    def engine(c, p):
        return ServingEngine(c, p, slots=2, max_len=64, steps_per_block=2)

    eng0 = engine(cfg, params)
    rids0 = [eng0.submit(p, max_new_tokens=5) for p in prompts]
    ref = eng0.run()
    with set_mesh(m4):
        eng = engine(lc, sp)
        eng.register_prefix(prompts[1][:4])
        rids = [eng.submit(p, max_new_tokens=5) for p in prompts]
        got = eng.run()
    out["engine"] = ([ref[r] for r in rids0], [got[r] for r in rids],
                     eng.prefix_hits)

    # speculative decoding
    toks = torch.tensor([[5, 9, 2, 7, 5, 9, 2, 7]])
    ref = speculative_generate(Generator(cfg, params, max_len=128), toks,
                               max_new_tokens=12, k=3)
    with set_mesh(m4):
        got = speculative_generate(Generator(lc, sp, max_len=128), toks,
                                   max_new_tokens=12, k=3)
    out["spec"] = (np.asarray(ref), np.asarray(got))

    # packed-resident W4 (fused q|k|v and gate|up on every rank)
    d = pl["w4"]
    cfg4, p4 = decoder_cfg(d["cfg"]), tree_to_torch(d["params"])
    state, specs = tree_to_torch(d["state"]), d["specs"]
    toks = torch.ones((1, 8), dtype=torch.long)
    g0 = Generator(cfg4, p4, specs=specs, state=state, mode="real",
                   max_len=64)
    ref = g0.generate_on_device(toks, max_new_tokens=6)
    lc4, sp4 = sharded(cfg4, p4, m4)
    with set_mesh(m4):
        g = Generator(lc4, sp4, specs=specs, state=state, mode="real",
                      max_len=64)
        lay = g.params["layers"]
        shapes = (lay["q"]["w_q_fused"].shape, lay["o"]["w_q"].shape,
                  lay["down"]["w_q"].shape,
                  g0.params["layers"]["q"]["w_q_fused"].shape)
        got = g.generate_on_device(toks, max_new_tokens=6)
    out["packed"] = (_np(ref), _np(got), shapes)

    # the HTTP server at tp = 4
    ref = _serve_all(engine(cfg, params), prompts) if rank == 0 else None
    got = _serve_all(engine(lc, sp), prompts, mesh=m4)
    out["http"] = (ref, got)

    # a VLM chat request with an image at tp = 2 (the tick's vision op)
    d = pl["vlm"]
    out["http_vlm"] = _vlm_server(rank, d, ms[2])

    # a crash in rank 0's scheduler
    out["crash"] = _crashed_server(engine(lc, sp), m4)
    return out


def _crashed_server(engine, mesh):
    """Rank 0's scheduler raises inside a tick, after the block: its waiter
    gets the error as HTTP 400 and the other ranks return from
    ``serve_follower`` (the barrier after it times out otherwise). Returns
    rank 0's response and the seconds the barrier waited."""
    import datetime
    import time

    import torch.distributed as dist

    from mquant_tpu_torch.serve.server import InferenceServer, serve_follower

    res = None
    if mesh.tp_index != 0:
        serve_follower(engine, mesh)
    else:
        srv = InferenceServer(engine, port=0, mesh=mesh)

        def boom(*a, **k):
            raise RuntimeError("injected scheduler failure")

        srv.worker._resolve = boom
        try:
            res = _post(srv.port, {"prompt": [1, 2, 3], "max_tokens": 4})
        finally:
            srv.shutdown()
    t0 = time.perf_counter()
    dist.monitored_barrier(mesh.tp_group,
                           timeout=datetime.timedelta(seconds=60))
    return res, time.perf_counter() - t0


def _vlm_server(rank: int, d: Dict, mesh):
    from mquant_tpu_torch.evaluation.adapter import VLMRunner
    from mquant_tpu_torch.models.registry import get_family

    fam = get_family(d["family"])
    cfg = fam.tiny_fn()
    params = tree_to_torch(d["params"])
    lc, sp = sharded(cfg, params, mesh)

    def runner(c, p):
        return VLMRunner(fam.name, c, p, max_len=256, mode="fp")

    def engine(r):
        return r.new_engine(2, 256, steps_per_block=2)

    ref = None
    if rank == 0:
        r0 = runner(cfg, params)
        ref = _serve_all(engine(r0), [], runner=r0, chats=d["chats"])
    r = runner(lc, sp)
    got = _serve_all(engine(r), [], mesh=mesh, runner=r, chats=d["chats"])
    return ref, got
