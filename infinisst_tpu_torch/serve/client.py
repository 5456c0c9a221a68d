"""Test client for the streaming translation server (a copy of
``infinisst_tpu/serve/client.py``, reading audio through the port's
``data/audio``).

Usage:
  python -m infinisst_tpu_torch.serve.client --wav path.wav [--port 8765] \
      [--target-lang German] [--realtime] [--multiplier M]
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json

import numpy as np


async def stream_file(
    host: str,
    port: int,
    wav: np.ndarray,
    source_lang: str = "English",
    target_lang: str = "German",
    chunk_ms: int = 960,
    realtime: bool = False,
    multiplier: int = None,
):
    reader, writer = await asyncio.open_connection(
        host, port, limit=16 * 1024 * 1024
    )

    async def send(obj):
        writer.write((json.dumps(obj) + "\n").encode())
        await writer.drain()

    open_msg = {
        "type": "open", "source_lang": source_lang,
        "target_lang": target_lang,
    }
    if multiplier is not None:
        open_msg["multiplier"] = multiplier
    await send(open_msg)
    opened = json.loads(await reader.readline())
    if opened["type"] != "opened":
        raise RuntimeError(f"the server did not open a stream: {opened}")

    chunk = int(chunk_ms * 16)
    texts = []

    async def recv_loop():
        while True:
            line = await reader.readline()
            if not line:
                return
            msg = json.loads(line)
            if msg["type"] == "text":
                texts.append(msg["content"])
                print("<<", msg["content"])
                if msg.get("final"):
                    return

    recv = asyncio.create_task(recv_loop())
    for i in range(0, len(wav), chunk):
        seg = wav[i : i + chunk]
        pcm16 = np.clip(seg * 32768.0, -32768, 32767).astype(np.int16)
        await send(
            {
                "type": "audio",
                "pcm_b64": base64.b64encode(pcm16.tobytes()).decode(),
                "finished": i + chunk >= len(wav),
            }
        )
        if realtime:
            await asyncio.sleep(chunk_ms / 1000.0)
    await recv
    writer.close()
    return texts


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--wav", required=True)
    p.add_argument("--source-lang", default="English")
    p.add_argument("--target-lang", default="German")
    p.add_argument("--realtime", action="store_true")
    p.add_argument("--multiplier", type=int, default=None,
                   help="requested latency multiplier (must be in the "
                   "server's --multipliers set)")
    args = p.parse_args(argv)

    from infinisst_tpu_torch.data.audio import get_waveform

    wav, sr = get_waveform(args.wav)
    if sr != 16000:
        raise SystemExit(f"{args.wav}: {sr} Hz, the server takes 16000 Hz")
    texts = asyncio.run(
        stream_file(
            args.host, args.port, wav, args.source_lang, args.target_lang,
            realtime=args.realtime, multiplier=args.multiplier,
        )
    )
    print("FINAL:", " ".join(texts))
    return texts


if __name__ == "__main__":
    main()
