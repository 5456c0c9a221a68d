"""The port's TCP server (``serve/server.py``) and test client
(``serve/client.py``) against their protocol, mirroring the first two
tests of ``tests/test_server.py`` on the CPU: asyncio clients on
127.0.0.1 (port 0) each get ``opened``, their texts and a ``final``
message, and the texts equal those of the same engine driven directly
with the same audio (a slot's tokens depend only on its own audio and
chunking, whatever the tick timing); a multiplier outside the server's
set gets ``error``; a speculative greedy and a speculative sampling pool
serve as they run directly.  Then the server's flags: the JAX server's
refusals (pooled sampling without speculation, the loaders' checks), and
``build_engine`` makes the engine ``main`` serves, speculative too.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

from infinisst_tpu_torch.serve import client as TCL
from infinisst_tpu_torch.serve import server as TSV
from tests.test_torch_serve import UNIT, port_engine

torch.set_num_threads(1)


def _direct(engine, wavs, mults):
    """The texts each stream gets from ``engine`` driven directly: the
    audio pushed in the client's 960 ms pieces, ticks until every stream
    is done."""
    slots = [engine.open_stream(f"d{i}", multiplier=m)
             for i, m in enumerate(mults)]
    for slot, wav in zip(slots, wavs):
        for i in range(0, len(wav), UNIT):
            engine.push_audio(slot, wav[i:i + UNIT],
                              finished=i + UNIT >= len(wav))
    texts = {s: [] for s in slots}
    while not all(engine.slots[s].done for s in slots):
        for s, text in engine.tick().items():
            texts[s].append(text)
    return [texts[s] for s in slots]


async def _bad_open(host, port):
    reader, writer = await asyncio.open_connection(host, port)
    writer.write((json.dumps({"type": "open", "multiplier": 7})
                  + "\n").encode())
    await writer.drain()
    msg = json.loads(await reader.readline())
    writer.close()
    return msg


def _serve(engine, clients):
    """Run the server on ``engine`` at 127.0.0.1, port 0, until every
    client coroutine (called with host and port) has returned."""
    srv = TSV.StreamingServer(engine, tick_interval=0.05)

    async def run():
        server = await asyncio.start_server(
            srv.handle, "127.0.0.1", 0, limit=TSV.READLINE_LIMIT)
        port = server.sockets[0].getsockname()[1]
        tick = asyncio.create_task(srv.tick_loop())
        try:
            return await asyncio.wait_for(
                asyncio.gather(*(c("127.0.0.1", port) for c in clients)),
                timeout=300)
        finally:
            tick.cancel()
            server.close()
            await server.wait_closed()

    return asyncio.run(run())


def _wavs(seed, units):
    rng = np.random.RandomState(seed)
    return [rng.randn(units * UNIT).astype(np.float32) * 0.1
            for _ in range(2)]


def test_server_two_clients():
    """Greedy pool of two, m = 1, at most 6 tokens a chunk."""
    wavs = _wavs(0, 2)
    eng = port_engine(2, 1, None, max_new_tokens=6)
    got = _serve(eng, [
        lambda h, p, w=w: TCL.stream_file(h, p, w) for w in wavs])
    want = _direct(port_engine(2, 1, None, max_new_tokens=6), wavs, (1, 1))
    assert got == want
    assert all(len(t) >= 1 for t in got) and any(any(t) for t in got)
    # each stream ended with its final message, which closed its slot
    assert not any(s.active for s in eng.slots)


def test_server_mixed_multiplier_clients():
    """One beam-2 pool serves an m = 1 and an m = 2 client; a client that
    asks for m = 7 gets an error and no slot."""
    wavs = _wavs(1, 4)
    eng = port_engine(2, 2, (1, 2))
    *got, err = _serve(eng, [
        lambda h, p: TCL.stream_file(h, p, wavs[0], multiplier=1),
        lambda h, p: TCL.stream_file(h, p, wavs[1], multiplier=2),
        _bad_open,
    ])
    assert err["type"] == "error" and "7" in err["message"]
    want = _direct(port_engine(2, 2, (1, 2)), wavs, (1, 2))
    assert got == want
    assert len(got[0]) >= 1 and len(got[1]) >= 1
    assert not any(s.active for s in eng.slots)


@pytest.mark.parametrize("flags,item", [
    (["--do-sample"], "speculative=True"),
    (["--spec-head-ids", "ids.npy"], "--spec-head-vocab"),
    (["--spec-adapter", "a.npz"], "requires --speculative"),
    (["--spec-lowrank-head", "f.npz"], "requires --speculative")])
def test_unported_server_flags_exit(flags, item):
    """The flags the port refused before now build their engine, and the
    JAX server's own refusals hold: pooled sampling needs --speculative,
    a shortlist file needs its width, the draft files need
    --speculative."""
    p = TSV.argparse.ArgumentParser()
    TSV.add_args(p)
    args = p.parse_args(flags + ["--device", "cpu", "--model-preset",
                                 "dryrun", "--dtype", "float32"])
    with pytest.raises((SystemExit, ValueError), match=item):
        TSV.build_engine(args)


@pytest.mark.parametrize("sample", [False, True])
def test_server_speculative_pool(sample):
    """A speculative greedy (and a speculative sampling, top-k 1) pool
    of two behind the server: each stream's texts equal the same engine's
    driven directly."""
    kw = dict(speculative=True, spec_draft_layers=1, spec_k=2,
              max_new_tokens=6)
    if sample:
        kw.update(do_sample=True, top_k=1, sample_seed=3)
    wavs = _wavs(2, 2)
    eng = port_engine(2, 1, None, **kw)
    got = _serve(eng, [
        lambda h, p, w=w: TCL.stream_file(h, p, w) for w in wavs])
    want = _direct(port_engine(2, 1, None, **kw), wavs, (1, 1))
    assert got == want
    assert any(any(t) for t in got)
    assert eng.spec_stats["rounds"] > 0


def test_build_engine_serves_the_dryrun_preset():
    p = TSV.argparse.ArgumentParser()
    TSV.add_args(p)
    args = p.parse_args(["--model-preset", "dryrun", "--device", "cpu",
                         "--dtype", "float32", "--pool-size", "2",
                         "--multipliers", "1,2", "--lang-pairs",
                         "English-German,English-Chinese"])
    eng = TSV.build_engine(args)
    assert (eng.pool, eng.beam, eng.multipliers, eng.max_new) == (
        2, 4, (1, 2), 20)
    assert set(eng.builders) == {("English", "German"),
                                 ("English", "Chinese")}
    assert eng.dec_state.k.dtype == torch.float32
    s = eng.open_stream("c", ("English", "Chinese"), multiplier=2)
    eng.push_audio(s, np.zeros(2 * UNIT, np.float32), finished=True)
    assert s in eng.tick() and eng.slots[s].done
    with pytest.raises(SystemExit, match="multiples of 128"):
        TSV.build_engine(p.parse_args(["--model-preset", "dryrun",
                                       "--device", "cpu", "--int8"]))
    # --speculative serves at beam 1 with the flags' draft and sampler
    eng = TSV.build_engine(p.parse_args([
        "--model-preset", "dryrun", "--device", "cpu", "--dtype",
        "float32", "--pool-size", "2", "--speculative",
        "--spec-draft-layers", "1", "--spec-k", "3", "--spec-head-vocab",
        "64", "--do-sample", "--top-k", "5", "--temperature", "0.7",
        "--spec-no-guard"]))
    assert (eng.beam, eng.speculative, eng.do_sample, eng.spec_k,
            eng.spec_draft_layers, eng._spec_breakeven) == (
                1, True, True, 3, 1, None)
    assert eng.sample["top_k"] == 5 and eng.sample["temperature"] == 0.7
    assert eng.params["spec_draft_head"]["prefix"].shape == (64,)
    s = eng.open_stream("c")
    eng.push_audio(s, np.zeros(UNIT, np.float32), finished=True)
    assert s in eng.tick() and eng.slots[s].done


def test_pushes_during_ticks_lose_no_samples(monkeypatch):
    """The server pushes audio from its event loop while a tick runs in a
    worker thread: with a fast stand-in for the device step, four pusher
    threads and a ticking thread under a short switch interval, every
    sample pushed is either consumed by a tick or still pending."""
    import sys
    import threading

    eng = port_engine(1, 1, None)
    slot = eng.open_stream("c")
    cs = eng.stream.chunk_samples(1)

    def fast_step(*args):
        return (np.zeros((eng.pool, eng.max_new), np.int64),
                np.zeros((eng.pool,), np.int64), 0)

    monkeypatch.setattr(eng, "_step", fast_step)
    piece = np.full(997, 0.01, np.float32)
    per_thread, n_threads = 500, 4
    stop = threading.Event()
    ticked = [0]

    def ticker():
        while not stop.is_set():
            eng.tick()
            ticked[0] += slot in eng.last_ticked

    def pusher():
        for _ in range(per_thread):
            eng.push_audio(slot, piece)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tick_thread = threading.Thread(target=ticker)
        tick_thread.start()
        pushers = [threading.Thread(target=pusher) for _ in range(n_threads)]
        for t in pushers:
            t.start()
        for t in pushers:
            t.join(timeout=60)
        stop.set()
        tick_thread.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not tick_thread.is_alive()
    assert not any(t.is_alive() for t in pushers)
    pushed = per_thread * n_threads * piece.size
    assert ticked[0] > 0
    assert ticked[0] * cs + len(eng.slots[slot].pending) == pushed
