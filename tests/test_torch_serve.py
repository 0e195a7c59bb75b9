"""The port's CaptionService (vacnic_tpu_torch/serve.py) on the CPU: the
cases of tests/test_serve.py but the sharded ones and the checkpoint
watcher, at VacnicConfig.tiny() with device="cpu".

Exactness: tokens equal and scores equal (float for float) to the port's
direct `generate_mm` on the same padded batch -- the same program on the
same inputs. The full-bucket and pixels cases are also token-identical to
the JAX CaptionService on the same rows and weights, and its scores agree
to 1e-4 (the tolerance of tests/test_torch_generate.py)."""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from vacnic_tpu.core.config import VacnicConfig as JC
from vacnic_tpu.data.synthetic import synthetic_batch as j_batch
from vacnic_tpu.models import fusion as JF
from vacnic_tpu.models.clip_vit import clip_vision_init as j_clip_init
from vacnic_tpu.serve import CaptionService as JService, ServeConfig as JServeConfig
from vacnic_tpu_torch.core.config import VacnicConfig
from vacnic_tpu_torch.data.synthetic import synthetic_batch
from vacnic_tpu_torch.infer import generate as G
from vacnic_tpu_torch.models.clip_vit import clip_vision_fwd
from vacnic_tpu_torch.models.weights_io import params_from_jax, tree_to
from vacnic_tpu_torch.serve import CaptionService, ServeConfig, make_http_server
from vacnic_tpu_torch.train.train_step import create_mask, face_mask_from_emb

SAMPLE_KEYS = ("article_ids", "image_cls", "face_emb", "names_art_ids")
PIXEL_KEYS = ("article_ids", "pixels", "face_emb", "names_art_ids")


def _jax_tree(seed: int):
    """The JAX tiny service tree, with a wider weight spread than the init's
    0.02 so the beams choose varied tokens, as numpy leaves."""
    jcfg = JC.tiny()
    key = jax.random.PRNGKey(seed)
    tree = {"model": JF.multimodal_bart_init(key, jcfg.bart, jcfg.fusion),
            "clip": j_clip_init(jax.random.fold_in(key, 3), jcfg.clip)}
    rng = np.random.RandomState(seed + 1)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.3 * rng.randn(*np.shape(x)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def setup():
    jparams = _jax_tree(0)
    return VacnicConfig.tiny(), params_from_jax(jparams), jparams


def _svc(cfg, params, **kw):
    return CaptionService(cfg, params, serve_cfg=ServeConfig(**kw), device="cpu")


def _rows(cfg, n, seed=0, keys=SAMPLE_KEYS, with_pixels=False):
    batch = synthetic_batch(cfg, n, seed=seed, with_pixels=with_pixels)
    return [{k: batch[k][i].numpy() for k in keys} for i in range(n)]


def _direct(cfg, params, rows, img_cls=None):
    """Decode the stacked rows directly through the path the service runs
    (CaptionService._decode_rows)."""
    b = {k: torch.from_numpy(np.stack([r[k] for r in rows])) for k in rows[0]}
    img = b["image_cls"] if img_cls is None else img_cls
    seqs, scores = G.generate_mm(
        params["model"], b["article_ids"], create_mask(b["article_ids"]), img,
        cfg.bart, cfg.fusion, cfg.decode, face_features=b["face_emb"],
        face_mask=face_mask_from_emb(b["face_emb"]), name_ids=b["names_art_ids"],
        name_mask=create_mask(b["names_art_ids"]), dtype=torch.float32, device="cpu")
    return seqs.numpy(), scores.numpy()


def _results(svc, rows, **kw):
    try:
        futs = [svc.submit(r, **kw) for r in rows]
        return [f.result(timeout=300) for f in futs]
    finally:
        svc.close()


def test_service_needs_a_card_unless_cpu(setup):
    """Without device= the service runs on "cuda": where torch sees no card
    it refuses to start instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg, params, _ = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CaptionService(cfg, params, serve_cfg=ServeConfig(buckets=(1,)))


def test_full_bucket_exact_vs_direct(setup):
    cfg, params, _ = setup
    rows = _rows(cfg, 4)
    svc = _svc(cfg, params, buckets=(4,), max_wait_ms=5000)
    results = _results(svc, rows)
    seqs, scores = _direct(cfg, params, rows)
    for i, res in enumerate(results):
        assert res["tokens"] == [int(t) for t in seqs[i]]
        assert res["score"] == float(scores[i])
        assert res["caption"] is None  # no tokenizer attached
    assert len(np.unique(seqs)) > 4  # the beams chose varied tokens
    st = svc.stats()
    assert st["requests"] == 4 and st["batches"] == 1
    assert st["bucket_counts"][4] == 1 and st["padded_rows"] == 0
    assert st["latency_p50_ms"] > 0
    assert st["latency_p50_ms"] <= st["latency_p95_ms"] <= st["latency_p99_ms"]


def _jax_results(jparams, rows, monkeypatch, **scfg):
    """The JAX CaptionService with its Pallas decode and encoder kernels
    selected (interpret mode on the CPU): the path the port's generate_mm
    mirrors, the decode kernel's bf16 rounding points included (the embedded
    token and x_out in bf16 even at f32). JAX's plain CPU path differs from
    it in the scores' fourth digit."""
    monkeypatch.setenv("VACNIC_PALLAS_DECODE", "1")
    monkeypatch.setenv("VACNIC_PALLAS_ENCODER", "1")
    svc = JService(JC.tiny(), jparams, serve_cfg=JServeConfig(**scfg))
    return _results(svc, rows)


def test_full_bucket_matches_jax_service(setup, monkeypatch):
    """The same four rows and weights through the JAX CaptionService."""
    cfg, params, jparams = setup
    rows = _rows(cfg, 4, seed=12)
    ours = _results(_svc(cfg, params, buckets=(4,), max_wait_ms=5000), rows)
    theirs = _jax_results(jparams, rows, monkeypatch, buckets=(4,), max_wait_ms=5000)
    for a, b in zip(ours, theirs):
        assert a["tokens"] == b["tokens"]
        assert a["score"] == pytest.approx(b["score"], rel=1e-4, abs=1e-4)


def test_padded_bucket_exact(setup):
    """3 requests into a 4-bucket: the service pads by repeating row 0; the
    real rows must match a direct decode of that exact padded batch."""
    cfg, params, _ = setup
    rows = _rows(cfg, 3, seed=1)
    svc = _svc(cfg, params, buckets=(4,), max_wait_ms=200)
    results = _results(svc, rows)
    seqs, scores = _direct(cfg, params, rows + [rows[0]])
    for i, res in enumerate(results):
        assert res["tokens"] == [int(t) for t in seqs[i]]
        assert res["score"] == float(scores[i])
    assert svc.stats()["padded_rows"] == 1


def test_coalescing_one_batch(setup):
    cfg, params, _ = setup
    svc = _svc(cfg, params, buckets=(1, 8), max_wait_ms=5000)
    _results(svc, _rows(cfg, 8, seed=2))
    st = svc.stats()
    # all 8 arrived well inside max_wait -> one full 8-bucket dispatch
    assert st["batches"] == 1 and st["bucket_counts"][8] == 1


def test_singleton_flush(setup):
    cfg, params, _ = setup
    (row,) = _rows(cfg, 1, seed=3)
    svc = _svc(cfg, params, buckets=(1, 4), max_wait_ms=1)
    try:
        res = svc.caption(row, timeout=300)
        assert len(res["tokens"]) == cfg.decode.max_length
        assert svc.stats()["bucket_counts"][1] == 1
    finally:
        svc.close()


def test_submit_validation(setup):
    cfg, params, _ = setup
    svc = _svc(cfg, params, buckets=(1,))
    (row,) = _rows(cfg, 1)
    try:
        with pytest.raises(ValueError, match="missing"):
            svc.submit({k: v for k, v in row.items() if k != "image_cls"})
        with pytest.raises(ValueError, match="expected shape"):
            svc.submit(dict(row, article_ids=row["article_ids"][:-1]))
        with pytest.raises(ValueError, match="unexpected"):
            svc.submit(dict(row, bogus=np.zeros(3)))
    finally:
        svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(row)


def test_decode_error_propagates(setup, monkeypatch):
    cfg, params, _ = setup

    def boom(*a, **k):
        raise RuntimeError("synthetic decode failure")

    monkeypatch.setattr(G, "generate_mm", boom)
    svc = _svc(cfg, params, buckets=(2,), max_wait_ms=500)
    try:
        futs = [svc.submit(r) for r in _rows(cfg, 2, seed=4)]
        for f in futs:
            with pytest.raises(RuntimeError, match="synthetic decode failure"):
                f.result(timeout=60)
        assert svc.stats()["errors"] == 2
    finally:
        svc.close()


def test_config_validation(setup):
    cfg, params, _ = setup
    with pytest.raises(ValueError, match="ascending"):
        _svc(cfg, params, buckets=(8, 4))
    with pytest.raises(ValueError, match="positive"):
        _svc(cfg, params, buckets=(0, 8))
    with pytest.raises(ValueError, match="input_kind"):
        _svc(cfg, params, input_kind="jpeg")


def test_non_numeric_payload_is_value_error(setup):
    """np.asarray raises TypeError on null/object values; submit turns that
    into ValueError so the HTTP layer answers 400, not a dropped
    connection."""
    cfg, params, _ = setup
    svc = _svc(cfg, params, buckets=(1,))
    try:
        (row,) = _rows(cfg, 1)
        with pytest.raises(ValueError, match="not convertible"):
            svc.submit(dict(row, article_ids=None))
        with pytest.raises(ValueError, match="not convertible"):
            svc.submit(dict(row, article_ids=[{"a": 1}] * 16))
    finally:
        svc.close()


def test_cancelled_future_does_not_kill_batcher(setup):
    """Caller-side Future.cancel() racing the batcher's set_result must not
    raise InvalidStateError in the worker: the service stays alive and
    serves the next request."""
    cfg, params, _ = setup
    svc = _svc(cfg, params, buckets=(1, 2), max_wait_ms=1)
    try:
        (row,) = _rows(cfg, 1, seed=7)
        fut = svc.submit(row)
        fut.cancel()  # may or may not win the race -- either is legal
        res = svc.caption(row, timeout=300)
        assert len(res["tokens"]) == cfg.decode.max_length
        assert svc._worker.is_alive()
    finally:
        svc.close()


def _serve(svc):
    srv = make_http_server(svc, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(base, payload: bytes, timeout=300):
    req = urllib.request.Request(f"{base}/v1/caption", data=payload,
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def test_http_roundtrip(setup):
    cfg, params, _ = setup
    svc = _svc(cfg, params, buckets=(1, 2), max_wait_ms=1)
    srv, base = _serve(svc)
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r)["ok"] is True
        (row,) = _rows(cfg, 1, seed=5)
        with _post(base, json.dumps({k: v.tolist() for k, v in row.items()}).encode()) as r:
            body = json.load(r)
        assert len(body["tokens"]) == cfg.decode.max_length
        assert isinstance(body["score"], float)
        seqs, _ = _direct(cfg, params, [row])
        assert body["tokens"] == [int(t) for t in seqs[0]]
        # malformed request -> 400 with the validation message
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, b'{"article_ids": [1, 2]}', timeout=30)
        assert ei.value.code == 400
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=30) as r:
            assert json.load(r)["requests"] >= 1
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


def test_http_burst_of_connections(setup):
    """128 clients that connect at once all get their caption: the server
    listens with a deep backlog (the stdlib's default of 5 resets such a
    burst)."""
    from concurrent.futures import ThreadPoolExecutor

    cfg, params, _ = setup
    svc = _svc(cfg, params, buckets=(1, 8, 32), max_wait_ms=5)
    srv, base = _serve(svc)
    rows = _rows(cfg, 8, seed=9)
    bodies = [json.dumps({k: v.tolist() for k, v in rows[i % 8].items()}).encode()
              for i in range(128)]
    start = threading.Barrier(len(bodies))

    def post(body):
        start.wait(timeout=60)
        with _post(base, body) as r:
            return json.load(r)["tokens"]

    try:
        with ThreadPoolExecutor(len(bodies)) as ex:
            got = list(ex.map(post, bodies))
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
    seqs, _ = _direct(cfg, params, rows)
    assert got == [[int(t) for t in seqs[i % 8]] for i in range(128)]
    assert svc.stats()["requests"] == 128


def test_http_error_routes(setup, monkeypatch):
    """404 for another route, 504 for a shed deadline, 500 for a decode
    failure, 503 once the service has closed."""
    cfg, params, _ = setup
    (row,) = _rows(cfg, 1, seed=6)
    body = {k: v.tolist() for k, v in row.items()}
    svc = _svc(cfg, params, buckets=(1,), max_wait_ms=1)
    srv, base = _serve(svc)
    try:
        for get in (lambda: urllib.request.urlopen(f"{base}/nowhere", timeout=30),
                    lambda: urllib.request.urlopen(urllib.request.Request(
                        f"{base}/v1/other", data=b"{}"), timeout=30)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                get()
            assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, json.dumps(dict(body, deadline_ms=-1.0)).encode())
        assert ei.value.code == 504
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, json.dumps(dict(body, deadline_ms="soon")).encode())
        assert ei.value.code == 400

        def boom(*a, **k):
            raise RuntimeError("synthetic decode failure")

        monkeypatch.setattr(G, "generate_mm", boom)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, json.dumps(body).encode())
        assert ei.value.code == 500
        svc.close()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, json.dumps(body).encode())
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/healthz", timeout=30)
        assert ei.value.code == 503
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


def test_precompile_warms_buckets(setup):
    cfg, params, _ = setup
    svc = _svc(cfg, params, buckets=(1, 2), max_wait_ms=1)
    try:
        svc.precompile()
        assert set(svc.stats()["bucket_decode_ms"]) == {1, 2}
        t0 = time.monotonic()
        svc.caption(_rows(cfg, 1, seed=6)[0], timeout=300)
        assert time.monotonic() - t0 < 5.0
    finally:
        svc.close()


def _pixel_rows(cfg, n, seed):
    return _rows(cfg, n, seed=seed, keys=PIXEL_KEYS, with_pixels=True)


def test_pixels_input_kind_exact_vs_direct(setup):
    """input_kind='pixels': the service runs the CLIP tower on the batch;
    results must match clip_vision_fwd + the same generate path run directly
    on the identical stacked batch."""
    cfg, params, _ = setup
    rows = _pixel_rows(cfg, 2, seed=21)
    svc = _svc(cfg, params, buckets=(2,), max_wait_ms=5000, input_kind="pixels")
    results = _results(svc, rows)
    px = torch.from_numpy(np.stack([r["pixels"] for r in rows]))
    _, img_cls = clip_vision_fwd(params["clip"], px, cfg.clip, torch.float32)
    seqs, scores = _direct(cfg, params, rows, img_cls=img_cls)
    for i, res in enumerate(results):
        assert res["tokens"] == [int(t) for t in seqs[i]]
        assert res["score"] == float(scores[i])


def test_pixels_matches_jax_service(setup, monkeypatch):
    """The same pixel rows and weights through the JAX CaptionService."""
    cfg, params, jparams = setup
    rows = _pixel_rows(cfg, 2, seed=22)
    jb = j_batch(JC.tiny(), 2, seed=22, with_pixels=True)
    np.testing.assert_array_equal(np.stack([r["pixels"] for r in rows]),
                                  np.asarray(jb["pixels"]))
    scfg = dict(buckets=(2,), max_wait_ms=5000, input_kind="pixels")
    ours = _results(_svc(cfg, params, **scfg), rows)
    theirs = _jax_results(jparams, rows, monkeypatch, **scfg)
    for a, b in zip(ours, theirs):
        assert a["tokens"] == b["tokens"]
        assert a["score"] == pytest.approx(b["score"], rel=1e-4, abs=1e-4)


def test_deadline_sheds_stale_requests(setup):
    """A past-deadline request is failed fast (TimeoutError) at batch-form
    time and does NOT occupy a decode slot; a live request in the same
    collected batch still decodes exactly."""
    cfg, params, _ = setup
    rows = _rows(cfg, 2, seed=31)
    svc = _svc(cfg, params, buckets=(2,), max_wait_ms=800)
    try:
        stale = svc.submit(rows[0], deadline_ms=0)
        time.sleep(0.05)  # let the deadline pass while the batcher holds
        live = svc.submit(rows[1])
        with pytest.raises(TimeoutError, match="deadline exceeded"):
            stale.result(timeout=300)
        res = live.result(timeout=300)
    finally:
        svc.close()
    # the live row becomes row 0 of the padded bucket (pad = repeat row 0)
    seqs, _ = _direct(cfg, params, [rows[1], rows[1]])
    assert res["tokens"] == [int(t) for t in seqs[0]]
    st = svc.stats()
    assert st["expired"] == 1 and st["requests"] == 1


def test_deadline_all_expired_skips_decode(setup):
    cfg, params, _ = setup
    (row,) = _rows(cfg, 1, seed=32)
    svc = _svc(cfg, params, buckets=(2,), max_wait_ms=100, default_deadline_ms=0)
    try:
        fut = svc.submit(row)  # default deadline from config
        with pytest.raises(TimeoutError):
            fut.result(timeout=60)
        st = svc.stats()
        assert st["expired"] == 1 and st["batches"] == 0
    finally:
        svc.close()


def test_update_params_hot_swap(setup):
    """After update_params the same request decodes with the NEW weights
    (against a direct decode under each tree), with no restart; stats track
    the weights version."""
    cfg, params, _ = setup
    params_b = dict(params, model=params_from_jax(_jax_tree(99)["model"]))
    rows = _rows(cfg, 1, seed=41)
    svc = _svc(cfg, params, buckets=(1,), max_wait_ms=1)
    try:
        res_a = svc.caption(rows[0], timeout=300)
        v = svc.update_params(params_b)
        assert v == 1 and svc.stats()["weights_version"] == 1
        res_b = svc.caption(rows[0], timeout=300)
    finally:
        svc.close()
    seqs_a, _ = _direct(cfg, params, rows)
    seqs_b, _ = _direct(cfg, params_b, rows)
    assert res_a["tokens"] == [int(t) for t in seqs_a[0]]
    assert res_b["tokens"] == [int(t) for t in seqs_b[0]]
    assert res_a["tokens"] != res_b["tokens"]


def test_deadline_bad_type_is_value_error(setup):
    """Untrusted HTTP input: a non-numeric deadline_ms surfaces as
    ValueError (HTTP 400), not a TypeError escaping the handler."""
    cfg, params, _ = setup
    svc = _svc(cfg, params, buckets=(1,))
    try:
        (row,) = _rows(cfg, 1)
        with pytest.raises(ValueError, match="deadline_ms"):
            svc.submit(row, deadline_ms=[100])
        with pytest.raises(ValueError, match="deadline_ms"):
            svc.submit(row, deadline_ms="soon")
    finally:
        svc.close()


def test_update_params_rejects_mismatched_tree(setup):
    """Hot-swap validation: structure, shape or dtype mismatches fail fast,
    before anything is swapped."""
    cfg, params, _ = setup
    svc = _svc(cfg, params, buckets=(1,))
    try:
        with pytest.raises(ValueError, match="structure"):
            svc.update_params({"model": {"nothing": np.zeros(3)}})
        with pytest.raises(ValueError, match="dtype"):
            svc.update_params(tree_to(params, dtype=torch.bfloat16))
        bad = dict(params, clip=dict(params["clip"], class_embedding=torch.zeros(7)))
        with pytest.raises(ValueError, match="shape"):
            svc.update_params(bad)
        as_list = dict(params, clip=dict(params["clip"], layers=list(params["clip"]["layers"])))
        with pytest.raises(ValueError, match="structure"):
            svc.update_params(as_list)
        assert svc.stats()["weights_version"] == 0  # nothing swapped
    finally:
        svc.close()


def test_defer_to_fill_avoids_padding(setup):
    """9 requests into a (8, 32) ladder: instead of padding a 32-bucket with
    23 dummy rows, the batcher dispatches one full 8-bucket and carries the
    remainder into an immediately-following batch. All results stay exact."""
    cfg, params, _ = setup
    rows = _rows(cfg, 9, seed=51)
    svc = _svc(cfg, params, buckets=(8, 32), max_wait_ms=500)
    results = _results(svc, rows)
    st = svc.stats()
    assert st["batches"] == 2 and st["bucket_counts"][8] == 2
    assert st["deferred_rows"] == 1 and st["padded_rows"] == 7
    seqs_a, _ = _direct(cfg, params, rows[:8])
    seqs_b, _ = _direct(cfg, params, [rows[8]] * 8)  # pad = repeat row 0
    for i in range(8):
        assert results[i]["tokens"] == [int(t) for t in seqs_a[i]]
    assert results[8]["tokens"] == [int(t) for t in seqs_b[0]]


def test_deadline_nan_is_value_error(setup):
    """NaN passes float() but `now > NaN` is always False -- a NaN deadline
    would never expire. Non-finite values are rejected like any other
    malformed input."""
    cfg, params, _ = setup
    svc = _svc(cfg, params, buckets=(1,))
    try:
        (row,) = _rows(cfg, 1)
        for bad in (float("nan"), float("inf"), float("-inf"), "nan"):
            with pytest.raises(ValueError, match="deadline_ms"):
                svc.submit(row, deadline_ms=bad)
    finally:
        svc.close()


def test_shed_runs_before_defer_split(setup):
    """Expired rows are shed BEFORE the defer-to-fill split: 8 expired + 1
    live into an (8, 32) ladder dispatch the live request in ONE batch."""
    cfg, params, _ = setup
    rows = _rows(cfg, 9, seed=61)
    svc = _svc(cfg, params, buckets=(8, 32), max_wait_ms=500)
    try:
        stale = [svc.submit(r, deadline_ms=0) for r in rows[:8]]
        time.sleep(0.05)  # deadlines pass while the batcher collects
        live = svc.submit(rows[8])
        res = live.result(timeout=300)
        for f in stale:
            with pytest.raises(TimeoutError):
                f.result(timeout=60)
    finally:
        svc.close()
    st = svc.stats()
    assert st["expired"] == 8 and st["requests"] == 1
    assert st["batches"] == 1 and st["deferred_rows"] == 0
    seqs, _ = _direct(cfg, params, [rows[8]] * 8)  # pad = repeat row 0
    assert res["tokens"] == [int(t) for t in seqs[0]]


def test_stable_target_selection(setup):
    """Fill-to-stable bucket choice: smallest bucket whose measured capacity
    covers rate*margin; largest when none; optimistic fallback for unknown
    decode times."""
    cfg, params, _ = setup
    svc = _svc(cfg, params, buckets=(1, 2, 4), stable_margin=1.2)
    try:
        svc._bucket_ms = {1: 200.0, 2: 200.0, 4: 300.0}
        assert svc._stable_target(10.0) == (4, 300.0)
        assert svc._stable_target(2.0) == (1, 200.0)
        assert svc._stable_target(100.0) == (4, 300.0)
        svc._bucket_ms = {1: 200.0, 2: 200.0}
        assert svc._stable_target(10.0) == (4, 200.0)
    finally:
        svc.close()


def test_fill_to_stable_extends_collection(setup, monkeypatch):
    """With a measured arrival rate and decode times making only the largest
    bucket stable, _fill_to_stable pulls queued arrivals up to the target;
    a single-request batch never waits."""
    cfg, params, _ = setup
    # stub the batcher loop so the enqueued items are not consumed
    monkeypatch.setattr(CaptionService, "_run", lambda self: None)
    svc = _svc(cfg, params, buckets=(1, 2, 4), max_wait_ms=1, fill_to_stable=True)
    try:
        now = time.monotonic()
        svc._arrivals.extend([now - 0.1 * i for i in range(20)])  # ~10 rps
        svc._bucket_ms = {1: 200.0, 2: 200.0, 4: 100.0}
        rows = _rows(cfg, 4, seed=71)
        items = [(r, None, now, None) for r in rows]
        svc._q.put((rows[2], None, now, None))
        svc._q.put((rows[3], None, now, None))
        assert len(svc._fill_to_stable(items[:2])) == 4
        t0 = time.monotonic()
        assert len(svc._fill_to_stable(items[:1])) == 1
        assert time.monotonic() - t0 < 0.05
        svc.scfg = dataclasses.replace(svc.scfg, fill_to_stable=False)
        assert len(svc._fill_to_stable(items[:2])) == 2
        svc.scfg = dataclasses.replace(svc.scfg, fill_to_stable=True)
        svc._bucket_ms = {}
        assert len(svc._fill_to_stable(items[:2])) == 2
        # negative fill budget (decode alone takes the stable cycle) ->
        # dispatch now, never wait
        svc._bucket_ms = {1: 200.0, 2: 200.0, 4: 300.0}
        t0 = time.monotonic()
        assert len(svc._fill_to_stable(items[:2])) == 2
        assert time.monotonic() - t0 < 0.05
    finally:
        svc.close()


def test_concurrent_submit_stress(setup):
    """Concurrent submitters + stats pollers must not race the batcher's
    _arrivals/_bucket_ms access."""
    cfg, params, _ = setup
    svc = _svc(cfg, params, buckets=(1, 4), max_wait_ms=5)
    rows = _rows(cfg, 8, seed=81)
    futs: list = []
    lock = threading.Lock()
    stop = threading.Event()
    poller_errors: list = []

    def submitter(i):
        for j in range(6):
            f = svc.submit(rows[(i * 6 + j) % len(rows)])
            with lock:
                futs.append(f)
            time.sleep(0.002 * (j % 3))

    def poller():
        try:
            while not stop.is_set():
                assert "bucket_decode_ms" in svc.stats()
                time.sleep(0.001)
        except BaseException as e:  # surfaced in the main thread below
            poller_errors.append(e)

    pt = threading.Thread(target=poller)
    try:
        threads = [threading.Thread(target=submitter, args=(i,)) for i in range(4)]
        pt.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        results = [f.result(timeout=300) for f in futs]
        assert len(results) == 24
        assert all(len(r["tokens"]) > 0 for r in results)
        assert svc._worker.is_alive()
        st = svc.stats()
        assert st["requests"] == 24 and st["errors"] == 0
    finally:
        stop.set()
        pt.join(timeout=5)
        svc.close()
    assert not poller_errors, poller_errors


def test_defer_saturation_guard(setup, monkeypatch):
    """When the stable target exceeds the defer-down bucket, the batcher
    dispatches the whole batch padded upward instead of pinning itself at
    b_down-sized dispatches."""
    monkeypatch.setattr(CaptionService, "_run", lambda self: None)
    cfg, params, _ = setup
    svc = _svc(cfg, params, buckets=(8, 32), stable_margin=1.5)
    try:
        now = time.monotonic()
        svc._arrivals.extend([now - 0.03 * i for i in range(67)])  # ~33 rps
        svc._bucket_ms = {8: 200.0, 32: 300.0}
        assert svc._stable_target(33.0)[0] == 32
        assert svc._defer_would_saturate(10, 8) is True
        svc._arrivals.clear()
        svc._arrivals.extend([now - 0.4 * i for i in range(8)])  # ~2.5 rps
        assert svc._defer_would_saturate(10, 8) is False
        svc._bucket_ms = {}
        assert svc._defer_would_saturate(10, 8) is False
    finally:
        svc.close()
