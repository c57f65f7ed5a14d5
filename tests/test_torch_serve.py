"""The port's serving entry point, ``repro_torch.launch.serve``, against the
JAX package's ``repro.launch.serve`` on the same arguments and weights.

- The parsers and the demo tokenizer (``parse_disagg``,
  ``encode_text``, ``media_from_url``, ``parse_chat_request``,
  ``token_piece``, ``_fault_kwargs``): identical outputs and errors.
- ``run_real`` with ``--device cpu``: the port's ``init_params`` is
  replaced by the JAX package's weights (``params_from_numpy`` of the JAX
  tree drawn from ``PRNGKey(0)``, the JAX CLI's own), and both CLIs
  print the same greedy streams, migrations and fault counts (f32 on the
  CPU: free-running greedy streams of this size do not split).
- The HTTP front of each package over the same weights: the same status,
  JSON body (ids and times aside) and SSE event sequence for the cases of
  tests/test_streaming_engine.py and tests/test_fault_tolerance.py:
  completion, streaming, models, 400, 404 and 503.  A seeded sampled
  stream is held to the same event sequence with its token ids aside:
  the port's seeded draws are its own (ROADMAP, queue 3).
- ``run_sim``: the same printed line.
- ``--device cuda`` (the default) without a card raises.
"""
import contextlib
import http.client
import io
import json
import re
import threading
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.simulator import DisaggConfig as JDisagg
from repro.engine.api import Engine as JEngine
from repro.launch import serve as JS
from repro.models import model as JM
from repro_torch.configs import get_config as tget_config
from repro_torch.core.simulator import DisaggConfig as TDisagg
from repro_torch.engine.api import Engine as TEngine
from repro_torch.launch import serve as TS
from repro_torch.models import model as TM
from repro_torch.params import params_from_numpy


def _jax_weights(cfg):
    """The JAX CLI's weights for ``cfg`` as the port's tree."""
    return params_from_numpy(
        jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0))),
        "cpu")


def _fake_init(cfg, gen, dtype=torch.float32):
    assert gen.device.type == "cpu" and dtype == torch.float32
    return _jax_weights(cfg)


@pytest.fixture
def jax_weights(monkeypatch):
    monkeypatch.setattr(TM, "init_params", _fake_init)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")


def _outcome(fn, *a):
    """(result, None) or (None, (exception type name, message))."""
    try:
        return fn(*a), None
    except Exception as e:  # noqa: BLE001 - the error is the result here
        return None, (type(e).__name__, str(e))


def _printed(fn, args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(args)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# parsers and the demo tokenizer
# ---------------------------------------------------------------------------
def _disagg_view(dc):
    return dc.name, dc.method, [(r, s.count, s.hw and s.hw.name, s.tp)
                                for r, s in dc.roles]


@pytest.mark.parametrize("s", [
    "E1,P1,D1", "E1,P3,D4", "E1@l40s,P3,D4", "E1@l40s,PD7@h800", "EPD1",
    "2EP,6D", "E1,E2,P1,D1", "E1@l40s, E2@L40S ,D3", "P1,D1",
    "E1@l40s,E2@h800", "E1@l40s,E2", "X1,D1", "E1@tpu", "E", "E1;P1", ""])
def test_parse_disagg_matches_jax(s):
    got, t_err = _outcome(TS.parse_disagg, s)
    want, j_err = _outcome(JS.parse_disagg, s)
    assert t_err == j_err
    if j_err is None:
        assert _disagg_view(got) == _disagg_view(want)


@pytest.mark.parametrize("text,vocab", [("describe this image", 512),
                                        ("", 32000), ("  a  b\tc\n", 7),
                                        ("w " * 50, 100352)])
def test_encode_text_and_token_piece_match_jax(text, vocab):
    got, want = TS.encode_text(text, vocab), JS.encode_text(text, vocab)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for t in (0, 7, int(want[0])):
        assert TS.token_piece(t) == JS.token_piece(t)


@pytest.mark.parametrize("arch", ["llava-1.5-7b", "qwen2-vl-7b"])
@pytest.mark.parametrize("url", ["http://x/cat.png", ""])
def test_media_from_url_matches_jax(arch, url):
    got = TS.media_from_url(url, tget_config(arch).reduced())
    want = JS.media_from_url(url, jget_config(arch).reduced())
    assert got.dtype == want.dtype and np.array_equal(got, want)


IMG = {"type": "image_url", "image_url": {"url": "http://x/a.png"}}
CHAT_BODIES = {
    "stop_tokens": {"messages": [{"role": "user", "content": "a b c"}],
                    "stop": "done", "stop_token_ids": [7],
                    "temperature": 0.3, "top_p": 0.9, "max_tokens": 5},
    "parts": {"model": "llava-1.5-7b-reduced", "stream": True, "seed": 4,
              "top_k": 3, "stop": ["x y", "z"],
              "messages": [{"role": "system", "content": "be brief"},
                           {"role": "user", "content": [
                               {"type": "text", "text": "what is"}, IMG,
                               {"type": "image_url", "image_url": "u2"}]}]},
    "unknown_model": {"model": "gpt-oss-419b",
                      "messages": [{"content": "hi"}]},
    "not_object": [1, 2],
    "no_messages": {},
    "message_not_object": {"messages": ["hi"]},
    "part_not_object": {"messages": [{"content": [42]}]},
    "content_not_list": {"messages": [{"content": 5}]},
    "unknown_part": {"messages": [{"content": [{"type": "audio"}]}]},
    "too_many_images": {"messages": [{"content": [IMG] * 17}]},
    "max_tokens_0": {"messages": [{"content": "hi"}], "max_tokens": 0},
    "prompt_too_long": {"messages": [{"content": "w " * 9000}]},
}


@pytest.mark.parametrize("case", sorted(CHAT_BODIES))
def test_parse_chat_request_matches_jax(case):
    body = CHAT_BODIES[case]
    got, t_err = _outcome(TS.parse_chat_request, body,
                          tget_config("llava-1.5-7b").reduced())
    want, j_err = _outcome(JS.parse_chat_request, body,
                           jget_config("llava-1.5-7b").reduced())
    assert t_err == j_err
    if j_err is None:
        (tp, tm, ts, tstream), (jp, jm, js, jstream) = got, want
        assert np.array_equal(tp, jp) and tp.dtype == jp.dtype
        assert (tm is None) == (jm is None)
        assert all(np.array_equal(a, b) for a, b in zip(tm or [], jm or []))
        assert len(tm or []) == len(jm or [])
        assert vars(ts) == vars(js) and tstream == jstream


def test_fault_kwargs_match_jax():
    """As tests/test_fault_tolerance.py::test_serve_cli_fault_knobs."""
    ns = TS.parse_args(["--fault", "crash@5:1,drop@9", "--shed",
                        "deadline"])
    kw, jkw = TS._fault_kwargs(ns), JS._fault_kwargs(ns)
    assert kw["shed_policy"] == jkw["shed_policy"] == "deadline"
    assert [e.kind for e in kw["fault_plan"].events] == ["crash", "drop"]
    assert [vars(e) for e in kw["fault_plan"].events] == \
        [vars(e) for e in jkw["fault_plan"].events]
    assert TS._fault_kwargs(TS.parse_args([])) == {} == \
        JS._fault_kwargs(TS.parse_args([]))


# ---------------------------------------------------------------------------
# run_real and run_sim
# ---------------------------------------------------------------------------
def _untimed(text: str) -> str:
    return re.sub(r"requests in [0-9.]+s", "requests in <s>", text)


@pytest.mark.parametrize("argv", [
    ["--arch", "llava-1.5-7b"],
    ["--arch", "stablelm-12b", "--disagg", "P1,D1", "--requests", "4"],
    ["--arch", "llava-1.5-7b", "--disagg", "E1,P2,D2", "--fault",
     "crash@8:3,drop@4", "--shed", "deadline"]],
    ids=["llava-E1P1D1", "stablelm-P1D1", "llava-faults"])
def test_run_real_prints_the_jax_streams(jax_weights, argv):
    args = TS.parse_args(argv + ["--device", "cpu"])
    got, want = _printed(TS.run_real, args), _printed(JS.run_real, args)
    assert got.count("req ") == args.requests
    assert _untimed(got) == _untimed(want)


@pytest.mark.parametrize("argv", [
    ["--arch", "llava-next-7b", "--dataset", "textcaps", "--rate", "8",
     "--n", "60", "--disagg", "E1@l40s,P3,D4"],
    ["--arch", "llava-1.5-7b", "--dataset", "pope", "--rate", "16", "--n",
     "80", "--disagg", "EPD8", "--policy", "prefill_first"],
    ["--arch", "qwen2-vl-7b", "--dataset", "vizwiz", "--rate", "4", "--n",
     "40", "--disagg", "2EP,2D", "--hw", "l40s"]])
def test_run_sim_prints_the_jax_line(argv):
    args = TS.parse_args(["--sim"] + argv)
    got = _printed(TS.main, ["--sim"] + argv)
    assert got.startswith(f"rate={args.rate} attainment=")
    assert got == _printed(JS.run_sim, args)


@pytest.mark.parametrize("argv", [["--requests", "1"], ["--http",
                                                        "--port", "0"]])
def test_cuda_without_a_card_raises(no_card, argv):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.main(argv)


# ---------------------------------------------------------------------------
# the HTTP front of both packages over the same weights
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fronts():
    """{"jax": port, "port": port}: the JAX front as its own tests build
    it, the port's through ``build_http`` (``--device cpu``), both on one
    EPD instance over the JAX CLI's weights."""
    jcfg = jget_config("llava-1.5-7b").reduced()
    jengine = JEngine(jcfg, JM.init_params(jcfg, jax.random.PRNGKey(0)),
                      JDisagg({"EPD": 1})).start()
    jhttpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                 JS.make_handler(jengine, jcfg))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TM, "init_params", _fake_init)
        thttpd, tengine = TS.build_http(TS.parse_args(
            ["--http", "--device", "cpu", "--disagg", "EPD1",
             "--host", "127.0.0.1", "--port", "0"]))
    threads = [threading.Thread(target=h.serve_forever, daemon=True)
               for h in (jhttpd, thttpd)]
    for t in threads:
        t.start()
    yield {"jax": jhttpd.server_address[1], "port": thttpd.server_address[1],
           "port_engine": tengine}
    for h, e in ((jhttpd, jengine), (thttpd, tengine)):
        h.shutdown()
        h.server_close()
        e.close(drain_timeout=0)
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()


def _exchange(port, method, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    payload = None if body is None else \
        body if isinstance(body, str) else json.dumps(body)
    conn.request(method, path, payload, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, resp.getheader("Content-Type"), resp.read().decode()
    conn.close()
    return out


def _view(text: str, ctype: str, mask_tokens: bool):
    """A response body without its ids and times: JSON as an object, SSE
    as the list of its events (``[DONE]`` kept), each "data: " line
    followed by a blank line."""
    def strip(obj):
        if isinstance(obj, dict):
            return {k: ("<tok>" if mask_tokens and k == "content"
                        else strip(v))
                    for k, v in obj.items() if k not in ("id", "created")}
        if isinstance(obj, list):
            return [strip(v) for v in obj]
        return obj
    if not ctype.startswith("text/event-stream"):
        return strip(json.loads(text))
    events = text.split("\n\n")
    assert events[-1] == "" and all(e.startswith("data: ")
                                    for e in events[:-1])
    return [e[6:] if e == "data: [DONE]" else strip(json.loads(e[6:]))
            for e in events[:-1]]


HTTP_CASES = {
    "completion": ("POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": [
            {"type": "text", "text": "describe this image"},
            {"type": "image_url", "image_url": {"url": "http://x/cat.png"}},
        ]}], "max_tokens": 3}),
    "completion_text": ("POST", "/v1/chat/completions", {
        "messages": [{"content": "a b c d"}], "max_tokens": 5,
        "temperature": 0}),
    "stream_greedy": ("POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hello there"}],
        "max_tokens": 3, "stream": True}),
    "stream_image": ("POST", "/v1/chat/completions", {
        "messages": [{"content": [IMG, {"type": "text", "text": "q"}]}],
        "max_tokens": 4, "stream": True, "temperature": 0}),
    "stream_seeded": ("POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hello there"}],
        "max_tokens": 3, "stream": True, "temperature": 0.5, "seed": 3}),
    "models": ("GET", "/v1/models", None),
    "healthz": ("GET", "/healthz", None),
    "get_unknown_path": ("GET", "/v1/nope", None),
    "post_unknown_path": ("POST", "/v1/completions", {"prompt": "hi"}),
    "unknown_model": ("POST", "/v1/chat/completions",
                      CHAT_BODIES["unknown_model"]),
    "bad_empty": ("POST", "/v1/chat/completions", "{}"),
    "bad_list": ("POST", "/v1/chat/completions", "[1,2]"),
    "bad_message": ("POST", "/v1/chat/completions", '{"messages":["hi"]}'),
    "bad_part": ("POST", "/v1/chat/completions",
                 '{"messages":[{"content":[42]}]}'),
    "bad_json": ("POST", "/v1/chat/completions", "{nope"),
    "too_many_images": ("POST", "/v1/chat/completions",
                        CHAT_BODIES["too_many_images"]),
    "max_tokens_0": ("POST", "/v1/chat/completions",
                     CHAT_BODIES["max_tokens_0"]),
    "prompt_too_long": ("POST", "/v1/chat/completions",
                        CHAT_BODIES["prompt_too_long"]),
}
STATUS = {"completion": 200, "completion_text": 200, "stream_greedy": 200,
          "stream_image": 200, "stream_seeded": 200, "models": 200,
          "healthz": 200, "get_unknown_path": 404, "post_unknown_path": 404,
          "unknown_model": 404}


@pytest.mark.parametrize("case", list(HTTP_CASES))
def test_http_front_matches_jax(fronts, case):
    method, path, body = HTTP_CASES[case]
    got = _exchange(fronts["port"], method, path, body)
    want = _exchange(fronts["jax"], method, path, body)
    assert got[0] == want[0] == STATUS.get(case, 400)
    assert got[1] == want[1]
    mask = case == "stream_seeded"
    assert _view(got[2], got[1], mask) == _view(want[2], want[1], mask)
    if want[1].startswith("text/event-stream"):
        assert got[2].endswith("data: [DONE]\n\n")
    # the front releases finished requests: no per-request state retained
    engine = fronts["port_engine"]
    assert not engine._queues and not engine.server.items


def test_http_overloaded_503_matches_jax():
    """As tests/test_fault_tolerance.py::test_http_overloaded_503: deadline
    shedding with the only instance dead rejects the submit."""
    out = []
    for pkg, get_config, Engine, Disagg, S, kw in (
            ("jax", jget_config, JEngine, JDisagg, JS, {}),
            ("port", tget_config, TEngine, TDisagg, TS, {"device": "cpu"})):
        cfg = get_config("llava-1.5-7b").reduced()
        params = JM.init_params(cfg, jax.random.PRNGKey(0)) \
            if pkg == "jax" else _jax_weights(cfg)
        engine = Engine(cfg, params, Disagg({"EPD": 1}),
                        shed_policy="deadline", **kw)
        engine.server.kill_instance(0)    # capacity gone before any submit
        httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                    S.make_handler(engine, cfg))
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            status, ctype, text = _exchange(
                httpd.server_address[1], "POST", "/v1/chat/completions",
                {"messages": [{"content": "hi"}]})
            out.append((status, _view(text, ctype, False)))
        finally:
            httpd.shutdown()
            httpd.server_close()
            engine.close(drain_timeout=0)
            t.join(timeout=30)
    assert out[0] == out[1]
    assert out[0][0] == 503
    assert out[0][1]["error"]["type"] == "overloaded_error"
