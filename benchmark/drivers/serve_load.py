"""The open-loop load of the serving cells, in a process of its own (it
never touches the card): independent users whose requests are due on a
fixed schedule, whether or not earlier ones have been answered.

Requests carry ``mixed`` and ``source`` float32 raw tiles in an ``.npz``
body, as ``serve/client.py`` sends them by default. Their sizes come from
``sizes`` with probabilities ``probs``; each request is one of a pool of
``templates[size]`` bodies of that size, encoded before the window from
the seed. The schedule is a Poisson process at ``rate_tiles_per_s`` over the
mean size: every seed gets the same multiset of sizes and of gaps (the
exponential distribution's quantiles), in its own order. Each request is
timed from when it was due, so a stall also delays the requests behind it;
one that fails or is not answered within ``answer_within_s`` of the
window's end has no latency.

Protocol: prints ``ready`` once its bodies are built and a warm-up request
of each size has been answered, reads ``go <t0>`` (a ``time.monotonic``
instant), sends the schedule from t0 on, and prints one JSON line of
results.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import queue
import sys
import threading
import time
from typing import Dict, List, Tuple

import numpy as np


def pool_layout(params: dict) -> Dict[int, Tuple[int, int]]:
    """-> {size: (first pool tile, templates)}: template j of size s holds
    pool tiles first + j*s ... first + (j+1)*s - 1."""
    out, at = {}, 0
    for s in params["sizes"]:
        k = params["templates"][str(s)]
        out[s] = (at, k)
        at += s * k
    return out


def pool_tiles(params: dict, seed: int, device="cpu"):
    """-> ((n, H, W, 2) float32 raw tiles of the template pool, alphas)."""
    from benchmark import inputs

    n = sum(s * k for s, k in ((s, params["templates"][str(s)]) for s in params["sizes"]))
    return inputs.make_tiles(seed, n, params["image_size"], device, what="serve pool")


def schedule(params: dict, seed: int, rate: float, seconds: float):
    """-> (due offsets in s, sizes, template indices) of every request."""
    sizes = np.array(params["sizes"])
    probs = np.array(params["probs"], dtype=np.float64)
    n = max(1, int(round(rate * seconds / float((sizes * probs).sum()))))
    counts = np.floor(probs * n).astype(int)
    for i in np.argsort(-(probs * n - counts))[: n - counts.sum()]:
        counts[i] += 1
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    req_sizes = rng.permutation(np.repeat(sizes, counts))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = rng.permutation(gaps * seconds / gaps.sum())
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    templates = np.array([rng.integers(params["templates"][str(s)]) for s in req_sizes])
    return due, req_sizes, templates


def bodies(params: dict, seed: int) -> Dict[Tuple[int, int], bytes]:
    tiles = pool_tiles(params, seed)[0].numpy()
    out = {}
    for s, (first, k) in pool_layout(params).items():
        for j in range(k):
            t = tiles[first + j * s: first + (j + 1) * s]
            buf = io.BytesIO()
            np.savez(buf, mixed=t[..., 0], source=t[..., 1])
            out[(s, j)] = buf.getvalue()
    return out


def _post(conn: http.client.HTTPConnection, body: bytes) -> List[float]:
    conn.request("POST", "/predict", body=body,
                 headers={"Content-Type": "application/octet-stream"})
    resp = conn.getresponse()
    data = resp.read()
    if resp.status != 200:
        raise RuntimeError(f"HTTP {resp.status}: {data[:200]!r}")
    return json.loads(data)["alpha"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rate", type=float, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--params", required=True, help="the traffic's parameters, JSON")
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(2)
    params = json.loads(args.params)
    body = bodies(params, args.seed)
    due, sizes, templates = schedule(params, args.seed, args.rate, args.seconds)
    workers = params["senders"]
    conns = [http.client.HTTPConnection("127.0.0.1", args.port, timeout=600)
             for _ in range(workers)]
    for s in params["sizes"]:  # warm-up: each size once, not timed
        _post(conns[0], body[(s, 0)])
    print("ready", flush=True)
    t0 = float(sys.stdin.readline().split()[1])
    answer_by = t0 + args.seconds + params["answer_within_s"]

    n = len(due)
    latency: List = [None] * n
    alphas: List = [None] * n
    late = [0.0] * n
    jobs: "queue.Queue" = queue.Queue()

    def send(c: int) -> None:
        conn = conns[c]
        while True:
            k = jobs.get()
            if k is None:
                return
            start = time.monotonic()
            late[k] = start - (t0 + due[k])
            if start > answer_by:
                continue
            conn.timeout = answer_by - start
            try:
                got = _post(conn, body[(int(sizes[k]), int(templates[k]))])
            except Exception as e:  # noqa: BLE001 - counted as failed, reported
                print(f"request {k} failed: {type(e).__name__}: {e}", file=sys.stderr)
                conn.close()
                conn = conns[c] = http.client.HTTPConnection("127.0.0.1", args.port)
                continue
            done = time.monotonic()
            if done <= answer_by:
                latency[k], alphas[k] = done - (t0 + due[k]), got

    threads = [threading.Thread(target=send, args=(c,), daemon=True) for c in range(workers)]
    for t in threads:
        t.start()
    for k in range(n):
        wait = t0 + due[k] - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        jobs.put(k)
    for _ in threads:
        jobs.put(None)
    for t in threads:
        t.join(timeout=max(answer_by - time.monotonic(), 0) + 5)
    for c in conns:
        c.close()
    print(json.dumps({
        "due": due.tolist(), "sizes": sizes.tolist(), "templates": templates.tolist(),
        "latency": latency, "alphas": alphas, "late_s": max(late) if late else 0.0,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
