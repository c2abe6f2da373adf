"""The port's decode engine (``tpuddp_torch/serving/decode``) against the JAX
package's (``tpuddp/serving/decode``), on the CPU: the paged cache under one
op script, ``transformer_tiny`` restored from one JAX native checkpoint into
both engines (the same streamed tokens for prompts submitted at once, greedy
and sampled, each compared token's margin above the logit tolerance;
prefill logits to rtol 1e-4 / atol 1e-5), the refusals' texts, the port's
own contracts (concurrent streams bitwise their solo runs, the stop token,
blocks freed for a queued joiner, drain), ``decode_stats`` rows and the v6
header under both validators, the exporter's scrape, and a checkpoint
written at ``parallel.model: 2``. The SIGTERM leg in a subprocess is
``slow`` and ``chaos``, as the JAX package's own."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tpuddp import config as jax_cfg
from tpuddp import nn as jax_nn
from tpuddp import optim as jax_optim
from tpuddp.models import load_model as jax_load_model
from tpuddp.observability import schema as jax_schema
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.parallel.mesh2d import mesh2d as jax_mesh2d
from tpuddp.serving.decode import DecodeEngine as JaxDecodeEngine
from tpuddp.serving.decode import PagedKVCache as JaxPagedKVCache
from tpuddp.serving.replica import _restore_variables as jax_restore
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.training.train_state import TrainState

from tpuddp_torch import config as cfg
from tpuddp_torch.models import load_model
from tpuddp_torch.observability import schema
from tpuddp_torch.parallel.tensor import TensorParallelLM
from tpuddp_torch.resilience.preemption import EXIT_PREEMPTED
from tpuddp_torch.serving import AdmissionError
from tpuddp_torch.serving.decode import DecodeEngine, PagedKVCache
from tpuddp_torch.serving.decode.engine import StreamedResult
from tpuddp_torch.serving.replica import _restore_variables, seeded_model
from tpuddp_torch.training import checkpoint as ckpt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME, VOCAB = "transformer_tiny", 32
RTOL, ATOL = 1e-4, 1e-5
CPU = [torch.device("cpu")]
PROMPT_LENS = (1, 3, 5, 8, 12, 2)


def _overrides(**kw):
    out = dict(model=NAME, vocab_size=VOCAB, num_replicas=1, max_slots=4, kv_blocks=17,
               kv_block_size=8, max_seq_len=32, max_new_tokens=8, stats_window=16,
               max_queue_depth=64, recovery_backoff_s=0.0)
    out.update(kw)
    return out


def _jax_cfg(**kw):
    return jax_cfg._merge_refusing_unknown(jax_cfg.DECODE_DEFAULTS, _overrides(**kw), "serving.decode")


def _port_cfg(**kw):
    return cfg.decode_config({"decode": _overrides(**kw)})


def _prompts(seed, lens=PROMPT_LENS):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=n).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """transformer_tiny's JAX init, in a JAX native checkpoint."""
    d = str(tmp_path_factory.mktemp("jax_tf"))
    params, mstate = jax_load_model(NAME, num_classes=VOCAB).init(
        jax.random.key(21), jnp.zeros((1, 2), jnp.int32))
    state = TrainState(params=params, model_state=mstate, opt_state=(),
                       step=jnp.zeros((), jnp.int32), rng=jax.random.key(1))
    jax_ckpt.save(jax_ckpt.checkpoint_path(d, 2), state, meta={"epoch": 2, "completed": 1})
    return d


@pytest.fixture(scope="module")
def engines(weights, cpu_devices, tmp_path_factory):
    """The pair this module shares: the JAX engine on one CPU device and the
    port's on the CPU, both restored from one JAX native file; the port's
    writes ``history.jsonl``."""
    out = str(tmp_path_factory.mktemp("port_decode"))
    jax_eng = JaxDecodeEngine.from_config(_jax_cfg(checkpoint_dir=weights),
                                          devices=cpu_devices[:1]).start()
    port = DecodeEngine.from_config(_port_cfg(checkpoint_dir=weights), out_dir=out,
                                    devices=CPU).start()
    yield jax_eng, port, out
    jax_eng.drain()
    port.drain()


def _tol(z):
    return ATOL + RTOL * np.abs(z)


def _full_logits(model, prompt, stream):
    """The port's full-forward logits of every generated position."""
    seq = np.concatenate([prompt, np.asarray(stream[:-1], np.int32)]) if len(stream) else prompt
    with torch.no_grad():
        out = model(torch.from_numpy(seq).long()[None])[0].double().numpy()
    return out[len(prompt) - 1: len(prompt) - 1 + len(stream)]


# --------------------------------------------------------------- the cache --


def _cache_script(cache_cls):
    c = cache_cls(layers=2, heads=4, head_dim=8, num_blocks=9, block_size=4, max_slots=3,
                  max_seq_len=16)
    log = [c.pool_shape(), c.allocatable, c.max_blocks]

    def snap():
        log.append((c.tables.tolist(), c.lengths.tolist(), c.free_blocks, c.free_slots,
                    c.used_blocks, c.active_slots, round(c.occupancy(), 6)))

    for op, arg in (("alloc", 9), ("alloc", 16), ("alloc", 2), ("alloc", 1), ("free", 1),
                    ("alloc", 4), ("free", 0), ("free", 0), ("alloc", 17), ("alloc", 0),
                    ("admit", 8), ("free", 2), ("alloc", 16), ("admit", 1)):
        try:
            if op == "alloc":
                log.append(("slot", c.allocate(arg)))
            elif op == "free":
                c.free(arg)
            else:
                log.append(("admit", c.can_admit(arg), c.blocks_needed(arg)))
        except (ValueError, RuntimeError) as e:
            log.append((type(e).__name__, str(e)))
        snap()
    for bad in (dict(num_blocks=1), dict(block_size=0), dict(num_blocks=3, max_seq_len=16)):
        kw = dict(layers=1, heads=1, head_dim=1, num_blocks=9, block_size=4, max_slots=2,
                  max_seq_len=8)
        kw.update(bad)
        try:
            cache_cls(**kw)
        except ValueError as e:
            log.append(str(e))
    return log


def test_the_paged_cache_is_the_jax_cache():
    assert _cache_script(PagedKVCache) == _cache_script(JaxPagedKVCache)


# ------------------------------------------------------ against the JAX engine --


def test_prompts_at_once_stream_the_jax_greedy_tokens(engines):
    jax_eng, port, _ = engines
    prompts = _prompts(0)
    got = [port.submit(f"t{i % 3}", p) for i, p in enumerate(prompts)]
    want = [jax_eng.submit(f"t{i % 3}", p) for i, p in enumerate(prompts)]
    streams = [list(r.stream(timeout=120)) for r in got]
    for p, s, g, w in zip(prompts, streams, got, want):
        ref = np.asarray(w.result(timeout=120))
        np.testing.assert_array_equal(np.asarray(g.result(timeout=1)), ref)
        assert s == ref.tolist() and len(s) == port.max_new_tokens
        # the comparison means something: at every step the greedy token
        # leads the runner-up by more than the logits' tolerance
        for z, tok in zip(_full_logits(port.model, p, s), s):
            top2 = np.sort(z)[-2:]
            assert int(np.argmax(z)) == tok
            assert top2[1] - top2[0] > _tol(top2[1]) + _tol(top2[0]), (p, s)


def test_temperature_draws_are_the_jax_draws(engines):
    jax_eng, port, _ = engines
    temp = 0.9
    prompts = _prompts(1, (4, 7, 2))
    got = [port.submit("t", p, temperature=temp, seed=11 + i) for i, p in enumerate(prompts)]
    want = [jax_eng.submit("t", p, temperature=temp, seed=11 + i) for i, p in enumerate(prompts)]
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        s = np.asarray(g.result(timeout=120))
        np.testing.assert_array_equal(s, np.asarray(w.result(timeout=120)))
        # each draw's uniform lies farther from the nearest CDF boundary than
        # the logits' tolerance can move the boundary
        for index, (z, tok) in enumerate(zip(_full_logits(port.model, p, s), s)):
            zt = z / temp
            prob = np.exp(zt - zt.max())
            cdf = np.cumsum(prob / prob.sum())
            u = np.random.RandomState(((11 + i) * 1000003 + index * 7919 + 0x5D) & 0x7FFFFFFF).random_sample()
            assert int(np.searchsorted(cdf / cdf[-1], u, side="right")) == tok
            bound = np.expm1(2 * _tol(z).max() / temp)
            assert np.abs(cdf - u).min() > bound, (i, index)


def test_prefill_logits_are_the_jax_prefill(engines):
    jax_eng, port, _ = engines
    jr, pr = jax_eng.replicas[0], port.replicas[0]
    zrow = np.zeros((pr.cache.max_blocks,), np.int32)
    for p in _prompts(2, (3, 8, 13)):
        bucket = min(b for b in port.buckets if b >= len(p))
        buf = np.zeros((1, bucket), np.int32)
        buf[0, :len(p)] = p
        got, pr.kpool, pr.vpool = pr._prefill(pr.kpool, pr.vpool, zrow, buf, len(p))
        want, jr.kpool, jr.vpool = jr._prefill(jr.params, jr.kpool, jr.vpool, jnp.asarray(zrow),
                                               jnp.asarray(buf), jnp.asarray(len(p), jnp.int32))
        assert got.shape == (VOCAB,)
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_refusals_are_the_jax_texts(engines, cpu_devices):
    jax_eng, port, _ = engines
    cases = [(np.zeros((2, 3), np.int32), {}), (np.zeros((3,), np.float32), {}),
             (np.asarray([0, VOCAB], np.int32), {}), (np.zeros((port.max_prompt_len + 1,), np.int32), {}),
             (np.zeros((2,), np.int32), {"max_new_tokens": 0}),
             (np.zeros((28,), np.int32), {"max_new_tokens": 8})]
    for tokens, kw in cases:
        with pytest.raises(AdmissionError) as err:
            port.submit("t", tokens, **kw)
        with pytest.raises(Exception) as jax_err:
            jax_eng.submit("t", tokens, **kw)
        assert (err.value.reason, str(err.value)) == (jax_err.value.reason, str(jax_err.value))
    for bad in (dict(model="toy_mlp"), dict(max_seq_len=256)):
        with pytest.raises(ValueError) as err:
            DecodeEngine.from_config(_port_cfg(**bad), devices=CPU)
        with pytest.raises(ValueError) as jax_err:
            JaxDecodeEngine.from_config(_jax_cfg(**bad), devices=cpu_devices[:1])
        assert str(err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as err:
        DecodeEngine.from_config(_port_cfg(num_replicas=2), devices=CPU)
    with pytest.raises(ValueError) as jax_err:
        JaxDecodeEngine.from_config(_jax_cfg(num_replicas=2), devices=cpu_devices[:1])
    assert str(err.value) == str(jax_err.value)


def test_a_model_2_checkpoint_is_refused_as_the_jax_restore_refuses_it(tmp_path, cpu_devices):
    """A file the JAX package wrote at ``parallel.model: 2`` (data 1): both
    restores raise the loader's TopologyMismatch with one text."""
    module = jax_load_model(NAME, num_classes=VOCAB)
    params, _ = module.init(jax.random.key(3), jnp.zeros((1, 2), jnp.int32))
    ddp = JaxDDP(module, jax_optim.Adam(lr=1e-2), jax_nn.CrossEntropyLoss(),
                 mesh=jax_mesh2d(1, 2, devices=cpu_devices[:2]))
    st = ddp.init_state(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), params=params,
                        model_state=())
    jax_ckpt.save_on_main(str(tmp_path), 0, st, world_size=2)
    assert jax_ckpt.read_topology(str(tmp_path / "ckpt_0.npz"))["model_size"] == 2
    t_params, t_state = module.init(jax.random.key(4), jnp.zeros((1, 2), jnp.int32))
    with pytest.raises(jax_ckpt.TopologyMismatch) as jax_err:
        jax_restore(str(tmp_path), "auto", t_params, t_state)
    with pytest.raises(ckpt.TopologyMismatch) as err:
        _restore_variables(str(tmp_path), "auto", seeded_model(NAME, VOCAB, (), 0))
    assert str(err.value) == str(jax_err.value) and "model=2" in str(err.value)


class _Mesh:
    """Model rank 0 of a (1, 2) world: the shard's shapes, no group."""

    model, data, model_index, data_index = 2, 1, 0, 0


@pytest.mark.parametrize("entry", ["prefill", "decode_step"])
def test_a_tensor_parallel_shard_is_refused_with_the_serving_path_named(entry):
    shard = TensorParallelLM(load_model(NAME, VOCAB), _Mesh())
    with pytest.raises(NotImplementedError) as err:
        getattr(shard, entry)(None, None, None, None, None)
    text = str(err.value)
    assert text.startswith("a tensor-parallel shard has no prefill or decode step")
    assert "tpuddp_torch.serving" in text and "reshard_checkpoint" in text
    assert "not ported" not in text and "Queue" not in text


# --------------------------------------------------------- the port's claims --


def test_concurrent_streams_are_bitwise_their_solo_runs(engines):
    _, port, _ = engines
    prompts = _prompts(3, (1, 3, 5, 8, 12, 2, 7, 10))
    solo = [np.asarray(port.submit("ref", p, seed=9).result(timeout=120)) for p in prompts]
    results = [port.submit(f"t{i % 3}", p, seed=9) for i, p in enumerate(prompts)]
    for r, want in zip(results, solo):
        np.testing.assert_array_equal(np.asarray(r.result(timeout=120)), want)


def test_the_stop_token_is_consumed(engines):
    _, port, _ = engines
    p = _prompts(4, (6,))[0]
    full = np.asarray(port.submit("t", p, seed=4).result(timeout=120))
    stop = int(full[2])
    out = np.asarray(port.submit("t", p, seed=4, stop_token=stop).result(timeout=120))
    np.testing.assert_array_equal(out, full[:list(full).index(stop)])
    empty = port.submit("t", p, seed=4, stop_token=int(full[0]))
    assert list(empty.stream(timeout=120)) == []
    assert np.asarray(empty.result(timeout=1)).shape == (0,)
    with pytest.raises(TimeoutError, match="stalled"):
        next(StreamedResult().stream(timeout=0.01))


def test_a_finisher_frees_its_blocks_for_a_queued_request(engines):
    _, port, _ = engines
    rng = np.random.RandomState(5)
    results = [port.submit("t", rng.randint(0, VOCAB, size=int(rng.randint(1, 13))).astype(np.int32),
                           max_new_tokens=int(rng.randint(1, 9))) for _ in range(12)]
    for r in results:
        assert np.asarray(r.result(timeout=120)).ndim == 1
    deadline = time.time() + 10
    while port.active_sequences() and time.time() < deadline:
        time.sleep(0.01)
    assert port.kv_occupancy() == 0.0 and port.active_sequences() == 0


def test_drain_then_submit_is_rejected():
    eng = DecodeEngine.from_config(_port_cfg(max_slots=2, kv_blocks=9), devices=CPU).start()
    res = eng.submit("t", np.asarray([1, 2, 3], np.int32))
    summary = eng.drain(reason="test")
    assert np.asarray(res.result(timeout=1)).ndim == 1
    with pytest.raises(AdmissionError) as e:
        eng.submit("t", np.asarray([1], np.int32))
    assert e.value.reason == "draining"
    assert summary["completed"] == 1 and eng.drain()["completed"] == 1


# ------------------------------------------------------- rows and the scrape --


def test_decode_stats_rows_and_the_v6_header_validate_under_both(engines):
    _, port, out = engines
    for r in [port.submit("v", p) for p in _prompts(6)]:
        r.result(timeout=120)
    port.stats.flush_window()
    path = os.path.join(out, "history.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    meta = rows[0]
    assert meta["type"] == "run_meta" and meta["api"] == "serving_decode"
    assert meta["decode"] == port.decode_meta() and meta["decode"]["max_slots"] == 4
    assert meta["survivability"]["max_recoveries"] == 2 and meta["restored_epoch"] == 2
    assert any(r["type"] == "decode_stats" for r in rows)
    assert schema.validate_history_file(path)[0] == []
    assert jax_schema.validate_history_file(path)[0] == []
    no_decode = [dict(meta)] + rows[1:]
    del no_decode[0]["decode"]
    assert schema.validate_history_records(no_decode) == jax_schema.validate_history_records(no_decode) != []


def test_an_exporter_scrape_matches_decode_stats(tmp_path):
    eng = DecodeEngine.from_config(_port_cfg(stats_window=8), out_dir=str(tmp_path / "run"),
                                   devices=CPU, observability={"exporter": True}).start()
    try:
        for r in [eng.submit("t", p) for p in _prompts(8, (3, 5, 9, 2))]:
            r.result(timeout=120)
        deadline = time.time() + 10
        while eng.active_sequences() and time.time() < deadline:
            time.sleep(0.01)
        text = urllib.request.urlopen(f"http://127.0.0.1:{eng.exporter.port}/metrics",
                                      timeout=10).read().decode()

        def value(name):
            for line in text.splitlines():
                if line.startswith(f"tpuddp_{name} "):
                    return float(line.split()[-1])
            raise AssertionError(f"tpuddp_{name} missing from /metrics:\n{text}")

        assert value("decode_tokens_total") == eng.stats.tokens == 4 * 8
        assert value("decode_sequences_completed_total") == eng.stats.completed == 4
        assert value("decode_requests_total") == eng.stats.submitted == 4
        assert value("decode_rejected_total") == 0
        assert value("decode_kv_occupancy") == eng.kv_occupancy() == 0.0
        assert value("decode_active_sequences") == eng.active_sequences() == 0
        assert value("decode_queue_depth") == eng.queue.depth() == 0
        assert value("decode_tokens_per_sec") == eng.stats.last_window["tokens_per_sec"] > 0
        assert "# TYPE tpuddp_decode_itl_ms summary" in text
    finally:
        eng.drain()


@pytest.mark.slow
@pytest.mark.chaos
def test_sigterm_drains_every_sequence_and_exits_75(tmp_path):
    settings = tmp_path / "decode.yaml"
    settings.write_text(yaml.dump({"out_dir": str(tmp_path / "out"), "local": {"device": "cpu"},
                                   "serving": {"decode": _overrides(max_new_tokens=24, max_seq_len=64,
                                                                    kv_blocks=33)}}))
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    env.pop("TPUDDP_FAULT", None)
    p = subprocess.Popen([sys.executable, "-u", "-m", "tpuddp_torch.serving", "--decode",
                          "--settings", str(settings), "--demo", "8", "--serve", "60"],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in p.stdout:
            lines.append(line)
            if line.startswith("demo traffic complete; serving"):
                p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == EXIT_PREEMPTED, "".join(lines)
    finally:
        if p.poll() is None:
            p.kill()
    summary = json.loads(lines[-1])
    assert summary["completed"] == 8 and summary["tokens"] == 8 * 24
    assert schema.validate_history_file(str(tmp_path / "out" / "history.jsonl"))[0] == []
