"""Serving driver, ported to PyTorch from ``repro.launch.serve``: batched
prefill + greedy decode, optionally retrieval-augmented through a PERSISTED
vector index (the paper's system as a first-class serving feature — see
examples/serve_rag.py for the full RAG loop). ``--index-dir`` loads a saved index (``PageANNIndex.save`` /
``DiskANNIndex.save`` / ``StarlingIndex.save`` / ``MutableIndex.save``
artifact — whichever kind the manifest names) through the ``VectorIndex``
lifecycle and retrieves neighbor ids for every prompt embedding before
decoding: the build-once / serve-many workflow, no index rebuild in the
serving process.

``--db-dir`` loads a whole multi-collection DATABASE
(``VectorService.load`` over a ``db.json`` artifact — see
``repro_torch.serve.service``) instead of one index: every prompt's retrieval is
routed to a named collection through ONE shared service. ``--route`` picks
the routing — a comma-separated list of ``:collection``-prefixed entries
cycled over the prompt batch (e.g. ``--route :wiki,:notes`` sends prompt
0 to ``wiki``, prompt 1 to ``notes``, prompt 2 to ``wiki``, …); it
defaults to round-robin over every collection in the database.

``--memory-budget`` serves the index (or every database collection) under
an out-of-HBM memory budget: only the hottest page records stay resident
on device, the rest stream from the artifact's ``pages.bin`` memmap per
hop — same results, bounded footprint (see ``repro_torch.core.MemoryBudget``).

``--mutable`` wraps the loaded index in a ``repro_torch.core.delta.MutableIndex`` (a
loaded mutable artifact is already one) and exercises the write path
end to end: the prompt embeddings are INSERTED as fresh documents through
``engine.insert``, retrieved back (each prompt now finds itself), then
DELETED again — the serving process takes writes without an index rebuild.

``--semantic-cache THRESHOLD`` (with ``--db-dir``) puts a
``repro_torch.serve.SemanticCache`` in front of the service and replays the
prompt retrievals to demonstrate similarity hits: repeat queries within
the cosine threshold of an answered one skip the dispatch entirely.

Observability (``repro_torch.obs``): ``--metrics-port PORT`` starts the stdlib
HTTP sidecar serving ``/metrics`` (Prometheus text exposition),
``/healthz`` and ``/stats`` next to the serving loop (0 = ephemeral
port, printed); ``--trace-out FILE`` threads a request tracer through
the engine/service and writes the capture as Chrome ``trace_event`` JSON
(open in Perfetto, or render with ``python -m repro_torch.obs.report``);
``--obs-selfcheck`` scrapes the process's own sidecar over real HTTP and
asserts the exposition parses and its counters reconcile with
``metrics()`` — the CI smoke gate.

The model is the port's ``repro_torch.models`` decoder of ``--arch`` (any
decoder family: dense, MoE, SSM, hybrid, VLM; an encoder-only arch exits
with the reference's message) at the arch's full width unless
``--smoke``; its weights are a random init from a
``torch.Generator`` seeded 0 and the prompts ``torch.randint`` under one
seeded 1 (``_model_and_prompts``), so they are not the reference's
``jax.random`` bits. Unlike the reference, no optimizer state is built:
serving never reads it. ``main`` takes ``device=`` (default ``"cuda"``;
the tests pass ``device="cpu"``): the model, the prompts and every index
live there.

Usage (on the card; --arch defaults to granite-3-2b, full width):
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --batch 4 --prompt-len 32 --gen 16 [--index-dir idx.pageann] \
      [--mutable] [--db-dir db/ [--route :wiki,:notes] [--semantic-cache 0.98]]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf


def generate(model, arch, prompts: torch.Tensor, gen: int) -> torch.Tensor:
    """Teacher-forced prefill then greedy decode. prompts: (B, T) on the
    model's device. Returns (B, gen) int32 tokens."""
    B, T = prompts.shape
    max_len = T + gen
    cache = tf.init_cache(arch, B, max_len, device=model.device)
    # prefill token-by-token through the decode path (cache-exact)
    logits = None
    for t in range(T):
        logits, cache = tf.decode_step(model, cache, prompts[:, t], t, arch)
    out = [torch.argmax(logits[:, : arch.vocab_size], -1).to(torch.int32)]
    for t in range(T, T + gen - 1):
        logits, cache = tf.decode_step(model, cache, out[-1], t, arch)
        out.append(torch.argmax(logits[:, : arch.vocab_size], -1).to(torch.int32))
    return torch.stack(out, dim=1)


def _model_and_prompts(arch, batch: int, prompt_len: int, device):
    """The driver's random model (a ``torch.Generator`` seeded 0) and
    prompts (``torch.randint`` under one seeded 1), both on ``device``."""
    gen = torch.Generator(device=device).manual_seed(0)
    model = tf.init_params(arch, gen, device=device)
    pgen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, arch.vocab_size, (batch, prompt_len),
                            generator=pgen, device=device, dtype=torch.int64)
    return model, prompts.to(torch.int32)


def embed_prompts(model, prompts: torch.Tensor) -> np.ndarray:
    """Each prompt's mean token embedding (B, d), float32 on the host: the
    retrieval query. The table is ``embed``, which is also the output
    head where the config ties embeddings (mamba2)."""
    with torch.no_grad():
        emb = model.embed[prompts.long()].mean(dim=1)
    return emb.to(torch.float32).cpu().numpy()


def _start_obs(args, source):
    """Start the metrics sidecar over ``source`` (an engine or service)
    when ``--metrics-port`` was given. Returns the server or None."""
    if args.metrics_port is None:
        return None
    from repro_torch.obs import MetricsServer, serve_registry

    registry = serve_registry(source)
    server = MetricsServer(
        registry, source=source, port=args.metrics_port
    )
    print(f"metrics sidecar: {server.url}/metrics (+ /healthz, /stats)")
    return server


def _parse_rate_limits(specs):
    """['wiki=200:400', 'notes=50'] -> {'wiki': (200.0, 400.0),
    'notes': (50.0, 50.0)} (burst defaults to the rate)."""
    out = {}
    for spec in specs or ():
        name, _, rhs = spec.partition("=")
        if not name or not rhs:
            raise SystemExit(f"--rate-limit {spec!r}: want COLL=RATE[:BURST]")
        rate, _, burst = rhs.partition(":")
        try:
            r = float(rate)
            b = float(burst) if burst else r
        except ValueError:
            raise SystemExit(f"--rate-limit {spec!r}: bad number")
        out[name] = (r, b)
    return out


def _start_frontend(args, svc):
    """Warm each collection's serving executable, then open the network
    frontend — external load must not pay first-dispatch compile."""
    from repro_torch.serve.http import HttpFrontend

    for name in svc.list_collections():
        dim = svc.index_of(name).dim
        svc.search(name, np.zeros((1, dim), np.float32))
    frontend = HttpFrontend(
        svc,
        port=args.http_port,
        max_inflight=args.max_inflight,
        default_deadline_ms=args.default_deadline_ms,
        rate_limits=_parse_rate_limits(args.rate_limit),
    )
    # the load generator greps this line for the bound address
    print(f"frontend: {frontend.url}", flush=True)
    return frontend


def _obs_selfcheck(server, source):
    """Scrape the process's own sidecar over real HTTP and reconcile the
    exposition against a fresh ``metrics()`` snapshot (no concurrent
    traffic at this point, so the counters must agree exactly)."""
    import json
    import urllib.request

    from repro_torch.obs import parse_prometheus_text, sample_value

    if urllib.request.urlopen(f"{server.url}/healthz").read() != b"ok\n":
        raise SystemExit("obs selfcheck: /healthz did not answer ok")
    text = urllib.request.urlopen(f"{server.url}/metrics").read().decode()
    parsed = parse_prometheus_text(text)     # raises on malformed lines
    m = source.metrics()
    checks = {
        "pageann_requests_total": m.requests,
        "pageann_batches_total": m.batches,
        "pageann_compile_misses_total": m.compile_misses,
        "pageann_early_exits_total": m.early_exits,
        "pageann_collections": m.collections,
    }
    for name, want in checks.items():
        got = sample_value(parsed, name)     # KeyError if the series is gone
        if got != float(want):
            raise SystemExit(
                f"obs selfcheck: {name} exposed {got}, metrics() says {want}"
            )
    if sample_value(parsed, "pageann_request_latency_ms_count") < m.requests:
        raise SystemExit(
            "obs selfcheck: latency histogram lost requests"
        )
    stats = json.loads(
        urllib.request.urlopen(f"{server.url}/stats").read()
    )
    if "metrics" not in stats:
        raise SystemExit("obs selfcheck: /stats payload has no metrics")
    print(
        f"obs selfcheck ok: {len(parsed)} series, "
        f"{m.requests} requests reconciled"
    )


def main(argv=None, *, device: str | torch.device = "cuda"):
    """Run the driver on ``device`` (the card unless the caller asks for
    the CPU). Returns the generated (B, gen) int32 tokens on that device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument(
        "--index-dir", default=None,
        help="saved VectorIndex directory: retrieve neighbor ids for each "
             "prompt embedding through the loaded index before decoding",
    )
    ap.add_argument("--retrieve-k", type=int, default=3)
    ap.add_argument(
        "--mutable", action="store_true",
        help="serve the index through the mutable delta tier and exercise "
             "engine.insert / engine.delete with the prompt embeddings",
    )
    ap.add_argument(
        "--db-dir", default=None,
        help="saved VectorService database directory (db.json): serve every "
             "collection from one process and route each prompt's retrieval",
    )
    ap.add_argument(
        "--route", default=None,
        help="comma-separated :collection entries cycled over the prompt "
             "batch (e.g. ':wiki,:notes'); default round-robins every "
             "collection in the database",
    )
    ap.add_argument(
        "--memory-budget", default=None,
        help="cap the device-resident page region of the loaded index / of "
             "each database collection: bytes ('268435456', '256MB') or a "
             "fraction of the page file ('0.25'); pages beyond the budget "
             "stream from the pages.bin memmap per hop with bit-identical "
             "results. Default: fully resident",
    )
    ap.add_argument(
        "--semantic-cache", type=float, default=None, metavar="THRESHOLD",
        help="(with --db-dir) put a semantic query cache in front of the "
             "service: repeat prompt embeddings within this cosine "
             "similarity of an answered one are served from the cache "
             "instead of dispatching (e.g. 0.98). Hit/miss counters are "
             "printed with the metrics. Default: no cache",
    )
    ap.add_argument(
        "--recall-target", type=float, default=None,
        help="serve the index with the autotuned operating point meeting "
             "this recall (the manifest 'tuned' section written by "
             "PageANNIndex.autotune) instead of hand-picked SearchParams. "
             "With --index-dir an artifact with no qualifying tuned point "
             "fails loudly; with --db-dir collections without one keep "
             "their own defaults",
    )
    ap.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="start the repro_torch.obs HTTP sidecar on this port serving "
             "/metrics (Prometheus text), /healthz and /stats (0 = pick "
             "an ephemeral port and print it). Default: no sidecar",
    )
    ap.add_argument(
        "--http-port", type=int, default=None, metavar="PORT",
        help="(with --db-dir) start the network frontend on this port: "
             "POST /search /insert /delete + GET /collections over the "
             "loaded database, with admission control and per-collection "
             "QoS; /metrics, /healthz and /stats are mounted on the same "
             "port (0 = ephemeral, printed as 'frontend: URL')",
    )
    ap.add_argument(
        "--max-inflight", type=int, default=64,
        help="frontend admission control: maximum concurrently admitted "
             "requests; excess requests are shed with 503 (default 64)",
    )
    ap.add_argument(
        "--default-deadline-ms", type=float, default=None, metavar="MS",
        help="frontend: default per-request queue deadline; a request "
             "still queued when it expires completes with 504 and counts "
             "as an engine shed. Per-request 'deadline_ms' overrides",
    )
    ap.add_argument(
        "--rate-limit", action="append", default=None,
        metavar="COLL=RATE[:BURST]",
        help="frontend QoS: token-bucket limit for one collection "
             "(requests/s, optional burst, e.g. 'wiki=200:400'); repeat "
             "per collection. Unlisted collections are unlimited",
    )
    ap.add_argument(
        "--serve-forever", action="store_true",
        help="(with --http-port) block serving HTTP until interrupted "
             "instead of exiting after the smoke retrievals — the mode "
             "an external load generator drives",
    )
    ap.add_argument(
        "--trace-out", default=None, metavar="FILE",
        help="thread a request tracer through the serving path and write "
             "the captured spans as Chrome trace_event JSON (view in "
             "Perfetto or render with python -m repro_torch.obs.report)",
    )
    ap.add_argument(
        "--obs-selfcheck", action="store_true",
        help="(with --metrics-port) scrape this process's own sidecar "
             "over HTTP and assert the exposition parses and reconciles "
             "with metrics() — exits nonzero on mismatch",
    )
    args = ap.parse_args(argv)
    if args.obs_selfcheck and args.metrics_port is None:
        raise SystemExit("--obs-selfcheck needs --metrics-port")
    if args.http_port is not None and not args.db_dir:
        raise SystemExit("--http-port needs --db-dir (a database to serve)")
    if args.serve_forever and args.http_port is None:
        raise SystemExit("--serve-forever needs --http-port")
    if (args.metrics_port is not None or args.trace_out) and not (
        args.db_dir or args.index_dir
    ):
        raise SystemExit(
            "--metrics-port/--trace-out need --index-dir or --db-dir "
            "(nothing to observe without a serving path)"
        )
    tracer = None
    if args.trace_out is not None:
        from repro_torch.obs import Tracer

        tracer = Tracer()
    memory_budget = None
    if args.memory_budget is not None:
        from repro_torch.core import MemoryBudget

        memory_budget = MemoryBudget.parse(args.memory_budget)
    if args.db_dir and args.index_dir:
        raise SystemExit("pass either --index-dir or --db-dir, not both")

    arch = get_arch(args.arch, smoke=args.smoke)
    if not arch.is_decoder:
        raise SystemExit(f"{args.arch} is encoder-only; no decode step")
    if args.semantic_cache is not None and not args.db_dir:
        raise SystemExit("--semantic-cache needs --db-dir")
    device = resolve_device(device)
    model, prompts = _model_and_prompts(
        arch, args.batch, args.prompt_len, device
    )

    if args.db_dir:
        from repro_torch.serve import SemanticCache, VectorService

        semantic_cache = (
            SemanticCache(threshold=args.semantic_cache)
            if args.semantic_cache is not None else None
        )
        emb = embed_prompts(model, prompts)
        with VectorService.load(
            args.db_dir, device=device, batch_size=args.batch,
            memory_budget=memory_budget,
            recall_target=args.recall_target,
            semantic_cache=semantic_cache,
            tracer=tracer,
        ) as svc:
            obs_server = _start_obs(args, svc)
            names = svc.list_collections()
            if not names:
                raise SystemExit(f"{args.db_dir}: database has no collections")
            route = [
                entry.lstrip(":")
                for entry in (args.route.split(",") if args.route else names)
                if entry.lstrip(":")
            ]
            unknown = sorted(set(route) - set(names))
            if unknown:
                raise SystemExit(
                    f"--route names unknown collections {unknown}; "
                    f"database has {sorted(names)}"
                )
            # the prompt-retrieval demo only makes sense against
            # collections in the model's embedding space; a pure serving
            # database (arbitrary dim, fronted over HTTP) skips it
            demo = [n for n in route if svc.index_of(n).dim == emb.shape[1]]
            if not demo and args.http_port is None:
                raise SystemExit(
                    f"prompt embedding dim {emb.shape[1]} matches no "
                    f"routed collection (dims: "
                    f"{ {n: svc.index_of(n).dim for n in route} })"
                )
            targets = [demo[i % len(demo)] for i in range(len(emb))] \
                if demo else []
            futs = [
                svc.submit(coll, e, k=args.retrieve_k)
                for coll, e in zip(targets, emb)
            ]
            svc.flush()
            m = svc.metrics()
            print(
                f"loaded database {args.db_dir} "
                f"({len(names)} collections: {', '.join(names)}); "
                f"compile cache {m.compile_hits} hits / "
                f"{m.compile_misses} misses"
            )
            for i, (coll, fut) in enumerate(zip(targets, futs)):
                ids = np.asarray(fut.result().result.ids)
                print(f"prompt {i} -> :{coll} -> ids {ids}")
            if semantic_cache is not None and targets:
                # replay the same prompts: every retrieval should now be a
                # cache hit (an already-completed future, no dispatch)
                replay = [
                    svc.submit(coll, e, k=args.retrieve_k)
                    for coll, e in zip(targets, emb)
                ]
                svc.flush()
                cached = sum(f.result().cached for f in replay)
                m = svc.metrics()
                print(
                    f"semantic cache (threshold {args.semantic_cache}): "
                    f"replay served {cached}/{len(replay)} from cache; "
                    f"{m.semantic_hits} hits / {m.semantic_misses} misses"
                )
            if args.http_port is not None:
                frontend = _start_frontend(args, svc)
                if args.serve_forever:
                    try:
                        while True:
                            time.sleep(3600)
                    except KeyboardInterrupt:
                        pass
                frontend.close()
            if obs_server is not None:
                if args.obs_selfcheck:
                    _obs_selfcheck(obs_server, svc)
                obs_server.close()
    elif args.index_dir:
        from repro_torch.core import MutableIndex, load_index
        from repro_torch.serve import BatchingEngine

        index = load_index(
            args.index_dir, device=device, memory_budget=memory_budget
        )
        tuned_params = None
        if args.recall_target is not None:
            # strict: a serving target against an artifact with no
            # qualifying tuned point is an operator error, not a fallback
            try:
                tuned_params = index.params_for_target(
                    recall_target=args.recall_target
                )
            except (LookupError, AttributeError) as e:
                raise SystemExit(
                    f"--recall-target {args.recall_target}: {e}"
                )
            print(
                f"--recall-target {args.recall_target}: serving tuned "
                f"operating point {tuned_params}"
            )
        if args.mutable and not isinstance(index, MutableIndex):
            index = MutableIndex(index)
        emb = embed_prompts(model, prompts)
        if emb.shape[1] != index.dim:
            raise SystemExit(
                f"prompt embedding dim {emb.shape[1]} != index dim {index.dim}"
            )
        with BatchingEngine.from_index(
            index, k=args.retrieve_k, batch_size=args.batch,
            params=tuned_params, tracer=tracer,
        ) as engine:
            obs_server = _start_obs(args, engine)
            rows = engine.search(emb)
            ids = np.stack([r.result.ids for r in rows])
            print(f"loaded {type(index).__name__} from {args.index_dir}; "
                  f"retrieved ids per prompt:\n{ids}")
            if args.mutable:
                # write path: insert the prompts as fresh documents, retrieve
                # them back (exact match -> each prompt finds itself), drop
                # them
                new_ids = engine.insert(emb)
                rows = engine.search(emb, k=1)
                found = np.stack([r.result.ids for r in rows])[:, 0]
                removed = engine.delete(new_ids)
                m = engine.metrics()
                print(f"mutable: inserted {m.inserts} docs -> ids {new_ids}; "
                      f"self-retrieval {found}; deleted {removed}")
                if not np.array_equal(np.sort(found), np.sort(new_ids)):
                    raise SystemExit(
                        "inserted prompts did not retrieve themselves"
                    )
            if obs_server is not None:
                if args.obs_selfcheck:
                    _obs_selfcheck(obs_server, engine)
                obs_server.close()

    if tracer is not None:
        tracer.save(args.trace_out)
        print(
            f"trace: {len(tracer)} spans -> {args.trace_out} "
            f"(render: python -m repro_torch.obs.report {args.trace_out})"
        )

    t0 = time.perf_counter()
    out = generate(model, arch, prompts, args.gen)
    out_host = out.cpu().numpy()
    dt = time.perf_counter() - t0
    toks = args.batch * args.gen
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, first call)")
    print(out_host[:, :8])
    return out


if __name__ == "__main__":
    main()
