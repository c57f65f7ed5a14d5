"""Serving entry point of the PyTorch port: real execution on the card, the
simulator at paper scale, or an OpenAI-style HTTP front.

Real:  PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-1.5-7b \
           --disagg E1,P1,D1 --requests 8
Sim:   PYTHONPATH=src python -m repro_torch.launch.serve --sim \
           --arch llava-next-7b --dataset textcaps --rate 16 --n 200
HTTP:  PYTHONPATH=src python -m repro_torch.launch.serve --http --port 8000
       curl localhost:8000/v1/chat/completions -d '{"messages": [...],
           "stream": true, "temperature": 0.7}'

The counterpart of the JAX package's ``repro.launch.serve``, with the same
functions, flags and output, and one flag more: ``--device`` (default
``cuda``).  On the card the real and HTTP modes serve the architecture at
its published width with random bf16 weights drawn on the card from
``torch.Generator("cuda").manual_seed(0)``; ``--device cpu`` serves the
reduced config in f32 (the model the JAX CLI serves) on the kernels' plain
versions.  Without a card and without ``--device cpu`` they raise.  The
simulator (``--sim``) runs on the host and never touches the card.

The HTTP front (DESIGN.md §13) speaks ``/v1/chat/completions`` with SSE
streaming and image inputs over the streaming ``Engine`` — stdlib only.
There is no real tokenizer (models run on random weights): text maps to
stable per-word hash token ids and generated ids render as ``<id>``
placeholders; an ``image_url`` part maps to a deterministic
pseudo-embedding seeded by the URL hash, standing in for a real vision
tower's patch embeddings.
"""
from __future__ import annotations

import argparse
import json
import re
import time
import zlib

import numpy as np

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.simulator import ROLE_SETS, DisaggConfig, RoleSpec


def parse_disagg(s: str) -> DisaggConfig:
    """Parse ``E1,P3,D4`` — optionally with per-role hardware overrides for
    heterogeneous clusters (DESIGN.md §7.2), e.g. ``E1@l40s,P3,D4@h800``."""
    from repro_torch.core.costmodel import HARDWARE

    merged: dict = {}   # role -> [count, hw | None]
    for part in s.split(","):
        m = re.fullmatch(r"(?:([A-Z]+)(\d+)|(\d+)([A-Z]+))(?:@(\w+))?",
                         part.strip())
        if not m:
            raise ValueError(f"bad disagg part {part!r} "
                             f"(e.g. E1,P3,D4 or E1@l40s,PD7@h800)")
        role = m.group(1) or m.group(4)
        if role not in ROLE_SETS:
            raise ValueError(f"unknown role {role!r}; "
                             f"known: {sorted(ROLE_SETS)}")
        n = int(m.group(2) or m.group(3))
        hw_name = m.group(5)
        hw = None
        if hw_name is not None:
            if hw_name.lower() not in HARDWARE:
                raise ValueError(f"unknown hardware {hw_name!r}; "
                                 f"known: {sorted(HARDWARE)}")
            hw = HARDWARE[hw_name.lower()]
        if role in merged:
            # a role group runs on one hardware profile; a repeated role
            # must name the same hardware (or none) regardless of order
            if merged[role][1] is not hw:
                raise ValueError(f"conflicting hardware for role {role!r}")
            merged[role][0] += n
        else:
            merged[role] = [n, hw]
    return DisaggConfig({role: n if hw is None else RoleSpec(count=n, hw=hw)
                         for role, (n, hw) in merged.items()})


def _fault_kwargs(args) -> dict:
    """Fault-tolerance knobs shared by the real and HTTP modes
    (DESIGN.md §15): ``--fault crash@100:1,stall@40:0+5`` injects a
    deterministic fault plan, ``--shed deadline`` turns on deadline-aware
    load shedding."""
    from repro_torch.engine.faults import FaultPlan

    kw = {}
    if getattr(args, "fault", None):
        kw["fault_plan"] = FaultPlan.parse(args.fault)
    if getattr(args, "shed", None):
        kw["shed_policy"] = args.shed
    return kw


def load_model(arch: str, device: str):
    """(cfg, params, device) of the real and HTTP modes.  On the card:
    the published width, bf16 weights drawn on the card from a generator
    seeded with 0.  On the CPU: the reduced config in f32 (the JAX CLI's
    model).  Raises for ``cuda`` without a card."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.models import model as M

    dev = resolve_device(device)
    if dev.type == "cuda":
        cfg = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        return cfg, M.init_params(cfg, gen, dtype=torch.bfloat16), dev
    cfg = get_config(arch).reduced()
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(0)), dev


def run_real(args):
    """Serve ``--requests`` closed-loop requests and print each one's
    tokens, the migrations and (with fault knobs) the fault counts.
    Returns the server."""
    from repro_torch.engine.server import HydraServer

    cfg, params, dev = load_model(args.arch, args.device)
    server = HydraServer(cfg, params, parse_disagg(args.disagg),
                         policy=args.policy, device=dev,
                         **_fault_kwargs(args))
    rng = np.random.default_rng(0)
    t0 = time.time()
    rids = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
        media = None
        if cfg.frontend != "none" and i % 2 == 0:
            media = (rng.standard_normal((cfg.media_tokens, cfg.d_model))
                     * 0.1).astype(np.float32)
        rids.append(server.submit(prompt, media=media,
                                  max_new_tokens=args.max_new_tokens))
    out = server.run()
    for rid in rids:
        print(f"req {rid}: {out[rid].generated}")
    print(f"{len(rids)} requests in {time.time()-t0:.1f}s, "
          f"{server.n_migrations} migrations "
          f"({server.migrated_bytes/1e6:.1f} MB)")
    if args.fault or args.shed:
        fs = server.fault_stats()
        print(f"faults: {fs['replays']} replays, {fs['shed']} shed, "
              f"{fs['transfer_retries']} transfer retries, "
              f"dead instances {fs['dead_instances']}")
    return server


# ---------------------------------------------------------------------------
# OpenAI-style HTTP front (DESIGN.md §13)
# ---------------------------------------------------------------------------
class UnknownModelError(ValueError):
    """Request names a model this server does not serve (-> HTTP 404)."""


def encode_text(text: str, vocab: int) -> np.ndarray:
    """Demo tokenizer: stable per-word hash ids (no real vocab here)."""
    toks = [zlib.crc32(w.encode()) % vocab for w in text.split()]
    return np.asarray(toks or [0], np.int32)


def media_from_url(url: str, cfg) -> np.ndarray:
    """Deterministic pseudo patch-embedding for an image reference."""
    rng = np.random.default_rng(zlib.crc32(url.encode()) & 0xFFFFFFFF)
    return (rng.standard_normal((cfg.media_tokens, cfg.d_model))
            * 0.1).astype(np.float32)


# request-hardening limits (DESIGN.md §15): every violation maps to a JSON
# 4xx, never a dead handler thread
MAX_IMAGES = 16            # images per request
MAX_PROMPT_TOKENS = 8192   # post-tokenization prompt length
MAX_COMPLETION_TOKENS = 2048


def parse_chat_request(body: dict, cfg):
    """``/v1/chat/completions`` body -> (prompt tokens, media list | None,
    SamplingParams, stream flag).  Raises ValueError on malformed input."""
    from repro_torch.core.request import SamplingParams

    if not isinstance(body, dict):
        raise ValueError("request body must be a JSON object")
    model = body.get("model")
    if model is not None and model != cfg.name:
        raise UnknownModelError(
            f"model {model!r} not found (serving {cfg.name!r})")
    msgs = body.get("messages")
    if not isinstance(msgs, list) or not msgs:
        raise ValueError("messages must be a non-empty list")
    words, media = [], []
    for m in msgs:
        if not isinstance(m, dict):
            raise ValueError("each message must be an object")
        content = m.get("content", "")
        if isinstance(content, str):
            words.append(content)
            continue
        if not isinstance(content, list):
            raise ValueError("message content must be a string or parts list")
        for part in content:
            if not isinstance(part, dict):
                raise ValueError("each content part must be an object")
            kind = part.get("type")
            if kind == "text":
                words.append(part.get("text", ""))
            elif kind == "image_url":
                url = part.get("image_url")
                url = url.get("url", "") if isinstance(url, dict) else str(url)
                if len(media) >= MAX_IMAGES:
                    raise ValueError(
                        f"too many images (limit {MAX_IMAGES})")
                media.append(media_from_url(url, cfg))
            else:
                raise ValueError(f"unsupported content part {kind!r}")
    stop: list = []
    raw_stop = body.get("stop") or []
    if isinstance(raw_stop, str):
        raw_stop = [raw_stop]
    for s in raw_stop:
        stop.extend(int(t) for t in encode_text(str(s), cfg.vocab_size))
    stop.extend(int(t) for t in body.get("stop_token_ids", []))
    max_tokens = int(body.get("max_tokens", 16))
    if not 1 <= max_tokens <= MAX_COMPLETION_TOKENS:
        raise ValueError(f"max_tokens must be in "
                         f"[1, {MAX_COMPLETION_TOKENS}], got {max_tokens}")
    sampling = SamplingParams(
        temperature=float(body.get("temperature", 0.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        seed=(None if body.get("seed") is None else int(body["seed"])),
        stop=tuple(stop),
        max_tokens=max_tokens)
    prompt = encode_text(" ".join(words), cfg.vocab_size)
    if len(prompt) > MAX_PROMPT_TOKENS:
        raise ValueError(f"prompt too long: {len(prompt)} tokens "
                         f"(limit {MAX_PROMPT_TOKENS})")
    return prompt, (media or None), sampling, bool(body.get("stream", False))


def token_piece(tok: int) -> str:
    return f"<{tok}>"


def make_handler(engine, cfg):
    """Build the request-handler class bound to one live engine."""
    from http.server import BaseHTTPRequestHandler

    from repro_torch.engine.faults import AdmissionError

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet by default (tests spin servers)
            pass

        def handle(self):
            try:
                super().handle()
            except (ConnectionResetError, BrokenPipeError):
                pass  # client dropped a kept-alive connection: not an error

        def _json(self, code: int, obj: dict):
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [
                    {"id": cfg.name, "object": "model",
                     "owned_by": "hydrainfer-repro"}]})
            elif self.path == "/healthz":
                self._json(200, {"status": "ok"})
            else:
                self._json(404, {"error": {"message": "not found"}})

        def do_POST(self):
            if self.path != "/v1/chat/completions":
                self._json(404, {"error": {"message": "not found"}})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                prompt, media, sampling, stream = \
                    parse_chat_request(body, cfg)
            except UnknownModelError as e:
                self._json(404, {"error": {"message": str(e),
                                           "type": "model_not_found"}})
                return
            except (ValueError, KeyError, TypeError, AttributeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": {"message": str(e),
                                           "type": "invalid_request_error"}})
                return
            try:
                rid = engine.submit(prompt, media=media, sampling=sampling)
            except AdmissionError as e:
                # deadline-aware shedding rejected the submit: capacity is
                # durably degraded (DESIGN.md §15)
                self._json(503, {"error": {"message": str(e),
                                           "type": "overloaded_error"}})
                return
            try:
                if stream:
                    self._stream(rid, len(prompt))
                else:
                    self._complete(rid, len(prompt))
            except (BrokenPipeError, ConnectionResetError):
                raise               # handled by handle(): client went away
            except Exception as e:  # engine fault: report, don't kill the
                engine.abort(rid)   # handler thread (connection reusable)
                engine.release(rid)
                self._json(500, {"error": {"message": str(e),
                                           "type": "internal_error"}})

        # -- one-shot response ------------------------------------------
        def _complete(self, rid: int, n_prompt: int):
            reason = "length"
            for ev in engine.events(rid):
                if ev.kind == "finish":
                    reason = ev.finish_reason
            toks = engine.result(rid).generated
            engine.release(rid)  # bound memory across the request stream
            self._json(200, {
                "id": f"chatcmpl-{rid}",
                "object": "chat.completion",
                "created": int(time.time()),
                "model": cfg.name,
                "choices": [{
                    "index": 0,
                    "message": {"role": "assistant",
                                "content": "".join(token_piece(t)
                                                   for t in toks)},
                    "finish_reason": reason}],
                "usage": {"prompt_tokens": n_prompt,
                          "completion_tokens": len(toks),
                          "total_tokens": n_prompt + len(toks)}})

        # -- SSE streaming ----------------------------------------------
        def _sse(self, obj):
            self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            self.wfile.flush()

        def _stream(self, rid: int, n_prompt: int):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            base = {"id": f"chatcmpl-{rid}",
                    "object": "chat.completion.chunk",
                    "created": int(time.time()), "model": cfg.name}
            try:
                for ev in engine.events(rid):
                    if ev.kind == "finish":
                        self._sse({**base, "choices": [
                            {"index": 0, "delta": {},
                             "finish_reason": ev.finish_reason}]})
                    else:
                        delta = {"content": token_piece(ev.token)}
                        if ev.kind == "first_token":
                            delta["role"] = "assistant"
                        self._sse({**base, "choices": [
                            {"index": 0, "delta": delta,
                             "finish_reason": None}]})
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                # client went away mid-stream: cancel the request so its
                # KV/image blocks free immediately
                engine.abort(rid)
            except Exception as e:
                # engine fault mid-stream: the 200 + SSE headers are gone,
                # so report through an SSE ``error`` event and end the
                # stream instead of killing the handler thread
                engine.abort(rid)
                try:
                    self._sse({"error": {"message": str(e),
                                         "type": "internal_error"}})
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass
            finally:
                engine.release(rid)  # bound memory across the stream

    return Handler


def build_http(args):
    """The HTTP front, not yet serving: (``ThreadingHTTPServer`` bound to
    ``args.host:args.port`` (port 0 picks a free one), the started
    ``Engine`` behind it).  The caller runs ``serve_forever`` and, when
    done, closes both."""
    from http.server import ThreadingHTTPServer

    from repro_torch.engine.api import Engine

    cfg, params, dev = load_model(args.arch, args.device)
    engine = Engine(cfg, params, parse_disagg(args.disagg),
                    policy=args.policy, device=dev,
                    **_fault_kwargs(args)).start()
    try:
        httpd = ThreadingHTTPServer((args.host, args.port),
                                    make_handler(engine, cfg))
    except OSError:
        engine.close(drain_timeout=0)
        raise
    return httpd, engine


def run_http(args):
    httpd, engine = build_http(args)
    print(f"serving {engine.server.cfg.name} [{args.disagg}] on "
          f"http://{args.host or 'localhost'}:{httpd.server_address[1]}"
          f"/v1/chat/completions")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        engine.close(drain_timeout=args.drain_timeout)


def run_sim(args):
    from repro_torch.core.costmodel import HARDWARE
    from repro_torch.core.metrics import summarize
    from repro_torch.core.simulator import Cluster, Simulator
    from repro_torch.data.workload import (IMAGE_TOKENS, PROFILES,
                                           make_requests, slo_for)

    cfg = get_config(args.arch)
    hw = HARDWARE[args.hw]
    slo = slo_for(args.arch, args.dataset)
    img = IMAGE_TOKENS.get(args.arch, cfg.media_tokens)
    reqs = make_requests(PROFILES[args.dataset], rate=args.rate, n=args.n,
                         image_tokens_per_image=img, slo=slo, seed=0)
    cl = Cluster(cfg, hw, parse_disagg(args.disagg), slo,
                 policy_name=args.policy)
    done = Simulator(cl).run(reqs, until=reqs[-1].arrival + 300)
    s = summarize(done, args.rate, reqs[-1].arrival)
    print(f"rate={args.rate} attainment={s.attainment:.2%} "
          f"p90_ttft={s.p90_ttft:.3f}s p90_tpot={s.p90_tpot*1e3:.1f}ms "
          f"tok/s={s.tokens_per_s:.0f}")


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's flags: the JAX CLI's, and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llava-1.5-7b", choices=ALL_ARCHS)
    ap.add_argument("--disagg", default="E1,P1,D1")
    ap.add_argument("--policy", default="hydra")
    ap.add_argument("--sim", action="store_true")
    ap.add_argument("--http", action="store_true",
                    help="OpenAI-style /v1/chat/completions front")
    ap.add_argument("--host", default="")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--dataset", default="textcaps")
    ap.add_argument("--rate", type=float, default=16.0)
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--hw", default="h800")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--fault", default="",
                    help="inject faults: kind@iteration[:iid][+arg],... "
                         "(kinds: crash stall alloc drop corrupt), e.g. "
                         "crash@100:1,stall@40:0+5")
    ap.add_argument("--shed", default="", choices=["", "off", "deadline"],
                    help="load shedding policy under degraded capacity")
    ap.add_argument("--drain-timeout", type=float, default=5.0,
                    help="graceful-shutdown drain window in seconds "
                         "(HTTP front)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="real and HTTP modes: the card at full width "
                         "(bf16), or the CPU at the reduced config (f32)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the mode the flags name; returns what it returns (``run_real``:
    the server)."""
    args = parse_args(argv)
    return (run_http if args.http else run_sim if args.sim
            else run_real)(args)


if __name__ == "__main__":
    main()
