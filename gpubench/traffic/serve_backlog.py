"""Serving in a closed backlog: ``Server.serve`` calls of ``requests_per_call``
requests each, the next call starting when the last returns, while the
window lasts; the last call runs to its end and counts whole.

Set-up draws the weights on the card from the seed, hands them to the
program's ``Server`` (which adopts them), and warms it with one call that
holds every length of the cell's pool once, longest first: every prefill
graph and the decode graph are captured there, so the window replays them.
Then, where the workload file asks for ``warm_calls``, it serves that many
calls of the window's own shape (``requests_per_call`` requests each, prompts
from a generator of their own, so the window's traffic is unchanged): a new
Server's first calls of one request each run slower than the later ones, on
an H100 by about 6 % for up to 46 calls, whatever set-up served before them.

The check, once the window has closed and the Server is gone: a sample of
the window's completions drawn from the seed, the one with the longest
sequence always in it; the weights drawn again from the seed; the plain
float32 reference run once over each prompt with its served tokens; and the
gaps by which the served tokens' logits lie below the reference's best at
their positions: the widest, or where routing near ties makes the widest no
measure (the MoE cell), the share of them over ``FAR``.  Every request must come back with ``max_new_tokens``
tokens (``eos`` is -1, so none stops early).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np

from gpubench import harness
from gpubench.reference import no_tf32
from gpubench.traffic import lengths

#: a served token "far" below the reference's best: half the standard
#: deviation of the logits over the vocabulary at these weights
FAR = 0.5


def token_gaps(logits, tokens):
    """Per sequence, at every position: the reference's best logit less its
    logit of the token given there."""
    return [(lg.max(-1).values - lg.gather(1, t[:, None].long())[:, 0]).double()
            for lg, t in zip(logits, tokens)]


def gap_stats(logits, tokens) -> Dict[str, float]:
    """:func:`token_gaps` over every position of every sequence."""
    import torch

    gaps = torch.cat(token_gaps(logits, tokens))
    return {"logit_gap": float(gaps.max()), "mean_gap": float(gaps.mean()),
            "far_share": float((gaps > FAR).double().mean()), "tokens_compared": gaps.numel()}


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize()


class Driver:
    def __init__(self, run: harness.Run):
        self.run = run
        self.p = run.params
        self.ref = harness.reference(run)
        self.server = None
        self.weights = None
        self.calls: List[Dict] = []

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.runtime.serving import ServeConfig, Server

        run, p = self.run, self.p
        cfg = harness.port_config(run)
        s = p["serve"]
        self.serve_cfg = ServeConfig(batch_slots=s["batch_slots"], max_len=s["max_len"],
                                     max_new_tokens=s["max_new_tokens"], eos=-1,
                                     temperature=0.0, seed=0)
        parts = run.record.setdefault("setup_parts", {})
        t0 = time.perf_counter()
        self.weights = harness.draw_weights(run.dims, run.seed, run.device, self.ref)
        sync(run.device)
        t1 = time.perf_counter()
        self.server = Server(cfg, self.serve_cfg, self.weights, device=run.device)
        self.pool = lengths.pool(p["prompts"])
        self.lengths = lengths.Lengths(self.pool, run.seed)
        self.tokens = lengths.rng(run.seed, 2)
        self.uid = 0
        t2 = time.perf_counter()
        # every length once, longest first: each prefill graph is captured
        # into the pool of the longest, and the decode graph is captured
        self._call(sorted(self.pool, reverse=True))
        sync(run.device)
        t3 = time.perf_counter()
        self._warm_calls(p.get("warm_calls", 0))
        sync(run.device)
        srv = self.server
        graphs = [g for g in [srv.graph, *srv.prefill_graphs.values()] if g is not None]
        parts.update({"weights_s": t1 - t0, "server_s": t2 - t1, "warm_s": t3 - t2,
                      "warm_calls_s": time.perf_counter() - t3,
                      "captures_s": sum(g.capture_seconds or 0.0 for g in graphs),
                      "prefill_graphs": len(srv.prefill_graphs),
                      "prefill_recaptures": srv.prefill_recaptures})

    def _warm_calls(self, calls: int) -> None:
        """``calls`` calls of the window's shape, in an order and with tokens
        of their own; their completions are not kept."""
        order = lengths.Lengths(self.pool, self.run.seed + 1)
        tokens = lengths.rng(self.run.seed, 4)
        for _ in range(calls):
            self._call(order.take(self.p["requests_per_call"]), tokens)

    def _requests(self, lens: List[int], tokens=None):
        from repro_torch.runtime.serving import Request

        out = []
        gen = self.tokens if tokens is None else tokens
        for prompt in lengths.prompts(lens, self.run.dims["vocab"], gen):
            out.append(Request(uid=self.uid, prompt=prompt))
            self.uid += 1
        return out

    def _call(self, lens: List[int], tokens=None):
        reqs = self._requests(lens, tokens)
        t0 = time.perf_counter()
        done = self.server.serve(reqs)
        return reqs, done, t0, time.perf_counter()

    # -- the window ------------------------------------------------------------

    def window(self, seconds: float, tracer) -> None:
        graph = self.server.graph
        replays = graph.replays if graph is not None else None
        n = self.p["requests_per_call"]
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            phase = tracer.boundary(time.perf_counter() - start)
            with tracer.span("gpubench.serve"):
                reqs, done, t0, t1 = self._call(self.lengths.take(n))
            self.calls.append({"requests": reqs, "done": done, "t0": t0, "t1": t1,
                               "phase": phase})
        rec = self.run.record
        rec["window_s"] = self.calls[-1]["t1"] - self.calls[0]["t0"]
        rec["decode_replays"] = (graph.replays - replays) if graph is not None else None
        rec["max_len"] = self.serve_cfg.max_len

        def served(calls):
            return [(len(r.prompt), len(c.tokens)) for call in calls
                    for r, c in zip(call["requests"], call["done"])]

        rec["served"] = served(self.calls)
        # the requests of the calls the profiler recorded: what the traced
        # window's metrics count
        rec["served_traced"] = served([c for c in self.calls if c["phase"] == "on"])
        rec["calls"] = [(c["phase"], c["t1"] - c["t0"], sum(len(d.tokens) for d in c["done"]))
                        for c in self.calls]

    def release(self) -> None:
        """The program's state freed: the Server, its caches and graphs, and
        the weights it adopted."""
        import torch

        self.server = None
        self.weights = None
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- results ---------------------------------------------------------------

    def counts(self) -> Tuple[int, int]:
        """(attempted, failed): a request fails unless it came back, once,
        with ``max_new_tokens`` tokens."""
        attempted = sum(len(c["requests"]) for c in self.calls)
        want = self.serve_cfg.max_new_tokens
        ok = 0
        for c in self.calls:
            by_uid = {d.uid: d for d in c["done"]}
            ok += sum(1 for r in c["requests"]
                      if r.uid in by_uid and len(by_uid[r.uid].tokens) == want)
        return attempted, attempted - ok

    def end_to_end(self) -> Dict[str, float]:
        tokens = sum(len(d.tokens) for c in self.calls for d in c["done"])
        latency = [(c["t1"] - c["t0"]) * 1e3 for c in self.calls]
        out = {"serve_tokens_per_s": tokens / self.run.record["window_s"]}
        if self.p["requests_per_call"] == 1:
            out["request_latency_p90_ms"] = float(np.percentile(latency, 90))
            self.run.record["latency_ms"] = {"p50": float(np.percentile(latency, 50)),
                                             "p90": out["request_latency_p90_ms"],
                                             "count": len(latency)}
        return out

    def sample(self) -> List[Tuple[np.ndarray, List[int]]]:
        """The completions the check compares: ``sample_requests`` of them
        drawn from the seed, the longest sequence among them."""
        prompts = {r.uid: r.prompt for c in self.calls for r in c["requests"]}
        pairs = [(prompts[d.uid], d.tokens) for c in self.calls for d in c["done"]]
        k = min(self.p["check"]["sample_requests"], len(pairs))
        longest = max(range(len(pairs)), key=lambda i: len(pairs[i][0]) + len(pairs[i][1]))
        rest = [i for i in range(len(pairs)) if i != longest]
        picked = [longest] + list(lengths.rng(self.run.seed, 3).choice(rest, size=k - 1,
                                                                      replace=False))
        return [pairs[i] for i in picked]

    def readings(self, precision: str = "fp32", weights=None) -> Dict[str, float]:
        """The gaps by which each served token's logit lies below the float32
        reference's best at its position: the widest (``logit_gap``), the
        mean (``mean_gap``) and the share over ``FAR`` (``far_share``); with
        ``precision`` other than fp32, the same of the token that the
        reference computed in that precision puts first (``control_*``)."""
        import torch

        run = self.run
        weights = weights or harness.draw_weights(run.dims, run.seed, run.device, self.ref)
        leaf = harness.leaf_reader(weights)
        seqs, served = [], []
        for prompt, tokens in self.sample():
            seq = np.concatenate([prompt, np.asarray(tokens[:-1], dtype=np.int32)])
            seqs.append((torch.from_numpy(seq).long().to(run.device), len(prompt)))
            served.append(torch.tensor(tokens, device=run.device))
        logits = self.ref.served_logits(run.dims, leaf, seqs)
        out = gap_stats(logits, served)
        if precision != "fp32":
            ctrl = self.ref.served_logits(run.dims, leaf, seqs, precision)
            picked = [c.argmax(-1) for c in ctrl]
            out.update({f"control_{k}": v for k, v in gap_stats(logits, picked).items()})
        return out

    def check(self) -> Dict[str, Tuple[float, float]]:
        no_tf32()
        got = self.readings()
        self.run.record["tokens_compared"] = got["tokens_compared"]
        _, failed = self.counts()
        lim = self.p["check"]
        return {**{k: (got[k], lim[f"{k}_limit"]) for k in ("logit_gap", "far_share")
                   if f"{k}_limit" in lim},
                "failed_requests": (failed, 0)}
