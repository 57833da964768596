"""Serving launcher, fixed batches or continuous batching (counterpart
of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch moe-gpt2 \\
        --batch 8 --prompt-len 128 --gen 32 --prefill batch
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch moe-transformerxl --batch 8 --prompt-len 256 --gen 16 \\
        --prefill batch
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --batch 4 --prompt-len 2048 --gen 32 --prefill batch
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch {olmoe-1b-7b,yi-34b,stablelm-12b,starcoder2-15b,gemma3-12b} \\
        [--num-layers N] --batch 2 --prompt-len 4096 --gen 32 \\
        --prefill batch
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama4-maverick-400b-a17b --num-layers 2 --batch 1 \\
        --prompt-len 256 --gen 32 --prefill batch
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b \\
        --batch 4 --prompt-len 2048 --gen 32 --prefill batch
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch seamless-m4t-large-v2 [--num-layers N] --batch 4 \\
        --prompt-len 64 --gen 8 --prefill batch
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
        --batch 4 --prompt-len 64 --gen 8 --prefill batch [--continuous]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch moe-gpt2 \\
        --model-axis 4 --batch 8 --prompt-len 128 --gen 32 --prefill batch \\
        [--exec-mode {sync,pipeline,decode_overlap}] [--pipeline-chunks N] \\
        [--plan-cache DIR [--precompute-plans]] \\
        [--plan-objective {traffic,overlap,replicate}] \\
        [--wire-dtype {f32,bf16,f8e4m3}] [--hier-dedup {off,on}] \\
        [--similarity-backend {exact,lsh}] [--lsh-bits N] \\
        [--condense-reuse {off,signature,always}] \\
        [--autotune DIR [--autotune-force]]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch moe-gpt2 \\
        --continuous --batch 8 --prompt-len 64 --gen 32 --requests 24 \\
        [--burst 3] [--arrival-every 4] [--max-steps 512] \\
        [--metrics-json PATH] [--trace] [--trace-out PATH]

Weights are random, drawn from ``--seed``; the prompts too. With
``--prefill batch`` one whole-prompt prefill runs first as a warm-up and
then once more timed. Then the prompt is fed token by token into the
cache (KV and, for hymba, the Mamba state), and ``--gen`` tokens are
decoded greedily. Every arch is served as a causal decoder, as the
reference serves it, moe-bert-large (non-causal in training) included.
The kernels of the path (the MoE archs: the expert FFN; every batched
prefill: flash attention at any prompt length, for every arch whose
mask it takes; hymba's: the Mamba scan too) run hand-written on the
card (``--device cuda``, the default, which must exist) and in their
plain versions on the CPU (``--device cpu``), where a prompt over 2048
tokens attends through the reference's streaming path. ``--num-layers
N`` (the port's own flag) serves the full-width arch cut to its first N
layers: yi-34b's 60 layers of bf16 weights alone take 68.8e9 bytes, and
llama4-maverick's 48 take 1.6e12 (two layers, a chunked-local pair,
69.3e9 with the embedding and the head). llama4's shared expert runs
beside its routed ones in every MoE sublayer, and its chunked-local
layers attend on K5 with the chunks folded into the batch. internvl2-2b
is served on its text path, as the reference's launcher serves it: no
prefix is fed (``engine.prefill(prefix=)`` takes one).

The encoder-decoder ``seamless-m4t-large-v2`` is served as the port's
own wiring, since the reference's launcher cannot serve it: its batched
prefill passes no ``enc_input`` (``repro/launch/serve.py:364-366``, so
``engine.py:427`` fails on ``None``), and its step feed builds the cache
with the default ``enc_len=0`` (``:387``), an empty encoder memory. Here
``enc_input`` [B, prompt_len, prefix_dim] (the reference's
``input_specs`` shape; the frontend is a stub) is drawn from ``--seed``
after the prompts; ``prefill(enc_input=)`` runs the encoder once and
every decoder layer's cross sublayer (timed under ``--prefill batch``;
run once untimed under ``--prefill step``, for its cross K/V); the cache
is made with ``enc_len = prompt_len`` and each layer's cross K/V written
into its ``ck`` / ``cv`` (``engine.write_cross_kv``); then the prompt is
fed token by token and ``--gen`` tokens decoded greedily, as for every
arch. On the card the encoder's layers and the cross layers attend on K5,
non-causal. ``--num-layers N`` cuts both stacks to N, as
``config.reduced`` does. ``--continuous`` and ``--model-axis > 1``
raise for an encoder-decoder (ROADMAP Queue 1 item 8.8).

The attention-free ``rwkv6-3b`` keeps no K/V: its decode cache is each
layer's WKV6 state and two token-shift states, which the step-wise
prompt feed fills (the prefill returns no state, as the reference's
does); the recurrence runs on kernel K7 in the batched prefill (one
launch a layer) and in every decode step (one a layer, the state updated
in place), and ``admit_slot`` zeroes a recycled slot's states.

``--model-axis M > 1`` serves over M virtual expert-parallel ranks held
by this one process (a flat mesh, as the reference's): the batched
prefill's MoE sublayers run sequence-sharded over the ranks (rank r
holds positions [r*S/M, (r+1)*S/M) of every prompt, at one rank's
capacity), and ``--exec-mode pipeline`` runs their exchange as the
chunked pipeline (``--pipeline-chunks``, default 4, 0 the exchange
estimate's count; bit for bit the sync prefill); ``decode_overlap`` runs
as sync: the reference overlaps its decode's combine all-reduce with the
shared-expert FFN, and the port's decode is the one-device one, with no
collective to hide; nor has it an all-to-all to chunk. The launcher prints the resolved
schedule. The decode steps are the one-device ones: the reference's
all-reduce decode gives their values bit for bit on virtual ranks
(:mod:`repro_torch.dist`). Attention and the KV cache are the
one-device ones.

``--plan-cache DIR`` keeps serialised exchange plans
(:mod:`repro_torch.plan.cache`) in DIR; with ``--precompute-plans`` the
launcher first stores the batched prefill's template and the decode
step's, and the prefill and every decode step then bind each request's
routing onto them: no ``build_exchange_plan`` call after the warm-up,
with logits bit for bit the uncached run's. ``--plan-objective`` only
threads through (serving never re-homes a prompt, so every objective
builds the same vanilla plan); it keys the cache. ``--wire-dtype``
sets the precision the expert-parallel prefill's rows ship at and keys
the cache too; ``--hier-dedup``, ``--similarity-backend``,
``--lsh-bits`` and ``--condense-reuse`` only thread the config through
(the mesh is flat and serving never condenses). ``--autotune DIR`` fills
the execution knobs no flag set from the tuned artifact for this
topology (:mod:`repro_torch.obs.autotune`, searched with the decode
term and kept when absent); an explicit flag beats the artifact. The
reference uses
its mesh only when it has more than one device, so on one device it
serves as M = 1; virtual ranks have no such cap, so the port's default
is 1. An arch without MoE sublayers serves the same with any M.

``--continuous`` switches the unit of work from a step to a request
(:mod:`repro_torch.serve.scheduler`): ``--requests`` prompts (drawn from
``--seed``) arrive in bursts of ``--burst`` every ``--arrival-every``
decode steps, are admitted FIFO into free cache slots between steps
(:func:`repro_torch.serve.engine.admit_slot`: a recycled slot restarts
at relative position 0 and decodes bit for bit as a fresh one), fed
their prompt token by token, decoded greedily for ``--gen`` tokens and
evicted, so their slots recycle mid-stream; ``--max-steps`` bounds the
loop. The decode is the one-device one at any ``--model-axis``. With
``--plan-cache --precompute-plans`` the decode template is stored first
and the loop builds no plan. Per-request SLOs (queue, time to first
token, time per output token) and the scheduler's occupancy are
``serve/*`` records of the metrics registry (``--metrics-json``, one a
step). ``--trace`` (or ``--trace-out``, default ``trace.json``) records
fenced spans, ``prefill_batch``, ``prefill_step`` and one ``decode`` a
model call, with the MoE phases inside them, and writes a Chrome trace.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

N_BATCHED_PREFILLS = 2     # warm-up + timed, as the reference launcher


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="moe-gpt2",
                    help="an arch of repro_torch.configs (ALIASES)")
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-test variant of --arch")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the full-width arch to its first N layers "
                         "(the port's own flag)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--prefill", choices=["step", "batch"], default="step",
                    help="step: feed the prompt token by token into the "
                         "cache; batch: also run (and time) one whole-"
                         "prompt prefill first")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="expert-parallel ranks (virtual, in this process)")
    ap.add_argument("--exec-mode",
                    choices=["sync", "pipeline", "decode_overlap"],
                    default=None,
                    help="MoE schedule of the expert-parallel prefill: in "
                         "order, the chunked pipeline (bit for bit sync), "
                         "or decode_overlap, which runs as sync here: "
                         "the one-device decode has no all-reduce to "
                         "overlap with the shared expert (default sync)")
    ap.add_argument("--pipeline-chunks", type=int, default=None,
                    help="capacity chunks of --exec-mode pipeline (default "
                         "4; 0 takes the exchange estimate's count)")
    ap.add_argument("--plan-cache", default="",
                    help="directory of the serialised exchange-plan cache: "
                         "the prefill and the decode steps bind their "
                         "routing onto cached static templates")
    ap.add_argument("--precompute-plans", action="store_true",
                    help="store this run's prefill and decode templates in "
                         "--plan-cache before serving")
    ap.add_argument("--plan-objective", default=None,
                    choices=["traffic", "overlap", "replicate"],
                    help="migration planner objective (serving never "
                         "re-homes a prompt, so it only keys the cache; "
                         "default traffic)")
    ap.add_argument("--hier-dedup", default=None, choices=["off", "on"],
                    help="the deduplicated hier wire; serving's mesh is "
                         "flat, so the prefill keeps the dense wire "
                         "(default off)")
    ap.add_argument("--wire-dtype", default=None,
                    choices=["f32", "bf16", "f8e4m3"],
                    help="precision the expert-parallel prefill's rows "
                         "ship at; part of the plan cache key (default "
                         "f32)")
    ap.add_argument("--similarity-backend", default=None,
                    choices=["exact", "lsh"],
                    help="condensation similarity backend; serving never "
                         "condenses, so it only threads the config "
                         "through and beats a tuned artifact's choice "
                         "(default exact)")
    ap.add_argument("--lsh-bits", type=int, default=None,
                    help="signed random projections per LSH bucket code "
                         "(default 8; see --similarity-backend)")
    ap.add_argument("--condense-reuse", default="off",
                    choices=["off", "signature", "always"],
                    help="cross-layer condense-plan reuse; serving never "
                         "condenses, so it only threads the config through")
    ap.add_argument("--autotune", default="",
                    help="TunedConfig artifact directory: fill the "
                         "execution knobs no flag set from the tuned "
                         "artifact for this mesh's topology (searched and "
                         "kept when absent; an explicit flag always wins)")
    ap.add_argument("--autotune-force", action="store_true",
                    help="search again even when a valid artifact exists")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: --requests prompts arrive in "
                         "bursts, are admitted into free cache slots "
                         "between decode steps and evicted on finish")
    ap.add_argument("--requests", type=int, default=8,
                    help="requests of --continuous")
    ap.add_argument("--burst", type=int, default=3,
                    help="requests arriving together (--continuous)")
    ap.add_argument("--arrival-every", type=int, default=4,
                    help="decode steps between bursts (--continuous)")
    ap.add_argument("--max-steps", type=int, default=512,
                    help="step budget of --continuous")
    ap.add_argument("--metrics-json", default="",
                    help="append metrics records (JSONL): the batched "
                         "prefill's, then one a decode step (serve/* SLO "
                         "and occupancy keys under --continuous)")
    ap.add_argument("--trace", action="store_true",
                    help="fenced spans around the batched prefill, the "
                         "prompt feed and every decode step; writes a "
                         "Chrome trace (see --trace-out)")
    ap.add_argument("--trace-out", default="",
                    help="trace JSON path (implies --trace; default "
                         "trace.json)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    return ap.parse_args(argv)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_continuous(args, cfg, luffy, model, plan_cache, registry,
                      device) -> Dict:
    """The continuous-batching request loop: one decode step per
    iteration, admissions and evictions between steps. Returns each
    request's tokens and SLOs, the host logits of every model call with
    the slots active in it, and the run's totals."""
    from repro_torch.serve.scheduler import ContinuousScheduler
    B, S = args.batch, args.prompt_len
    # per-slot relative frames: an occupant never holds more than
    # prompt + gen positions, however long the run
    s_max = S + args.gen
    r = np.random.default_rng(args.seed)
    prompts = r.integers(1, cfg.vocab_size,
                         (args.requests, S)).astype(np.int32)
    # bursts of --burst requests land together every --arrival-every
    # decode steps
    arrival_step = [(i // max(1, args.burst)) * max(1, args.arrival_every)
                    for i in range(args.requests)]
    if plan_cache is not None and args.precompute_plans and cfg.uses_moe:
        from repro_torch.plan.cache import precompute_decode_plans
        key = precompute_decode_plans(cfg, luffy, B, plan_cache)
        print(f"precomputed decode plan: {key}")
    cache = model.new_cache(B, s_max)
    sched = ContinuousScheduler(B)
    step = submitted = 0
    step_logits, step_active = [], []
    _sync(device)
    t0 = time.perf_counter()
    while step < args.max_steps:
        now = time.perf_counter()
        while submitted < args.requests \
                and arrival_step[submitted] <= step:
            sched.submit(prompts[submitted], args.gen, now=now)
            submitted += 1
        if sched.all_done():
            if submitted >= args.requests:
                break
            step += 1          # idle until the next burst lands
            continue
        for slot, _ in sched.admit(now=now):
            model.admit_slot(cache, slot, cache["pos"])
        # an asynchronous copy: the logits' copy below is the step's one
        # device sync
        toks = torch.from_numpy(sched.next_feed()).to(device,
                                                      non_blocking=True)
        step_active.append(np.array([q is not None for q in sched.slots]))
        with obs_trace.phase("decode", cat="step", step=step,
                             active=sched.active_slots) as sp:
            logits, cache = model.decode_step(cache, toks, luffy=luffy,
                                              plan_cache=plan_cache)
            logits = sp.fence(logits)
        host = logits.cpu().numpy()        # the step's one device copy
        step_logits.append(host)
        sched.observe(host, now=time.perf_counter())
        if registry is not None:
            obs_metrics.write_jsonl(args.metrics_json,
                                    registry.observe(step,
                                                     sched.step_metrics()))
        step += 1
    dt = time.perf_counter() - t0
    done = sorted(sched.done, key=lambda q: q.rid)
    tok = sched.generated_tokens
    print(f"continuous: {len(done)}/{args.requests} requests, {tok} tokens "
          f"in {dt:.2f}s ({tok / max(dt, 1e-9):.1f} tok/s), {step} steps, "
          f"slot_churn={sched.slot_churn}")

    def mean(name):
        vals = [getattr(q, name) for q in done]
        vals = [v for v in vals if v is not None]
        return float(np.mean(vals)) if vals else float("nan")

    slo = {name: mean(name) for name in ("queue_ms", "ttft_ms", "tpot_ms")}
    if done:
        print(f"SLO: queue {slo['queue_ms']:.1f}ms ttft {slo['ttft_ms']:.1f}"
              f"ms tpot {slo['tpot_ms']:.1f}ms")
    if sched.queue or sched.active_slots:
        print(f"WARNING: --max-steps hit with {len(sched.queue)} queued "
              f"and {sched.active_slots} active requests")
    calls = len(step_logits)
    return {"requests": {q.rid: list(q.generated) for q in done},
            "slot_churn": sched.slot_churn, "steps": step,
            "model_calls": calls, "step_logits": step_logits,
            "step_active": step_active, "slo": slo,
            "tok_s": tok / max(dt, 1e-9),
            "decode_ms_per_step": dt / max(calls, 1) * 1e3,
            "finished": len(done), "prompts": prompts,
            "arrival_step": arrival_step}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Serve; returns what was measured (tokens, logits, times)."""
    args = parse_args(argv)
    from repro_torch.comm.topology import Topology
    from repro_torch.config import LuffyConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.dist import make_dist, single_device
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model, resolve_device
    from repro_torch.obs import autotune as obs_at
    from repro_torch.obs.calibrate import backend_of
    from repro_torch.plan.exchange import schedule_of
    from repro_torch.serve.engine import prefill_capacity

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.num_layers:
        if args.reduced:
            raise ValueError("--num-layers cuts the full-width arch, not "
                             "the --reduced variant")
        cfg = dataclasses.replace(
            cfg, num_layers=args.num_layers,
            num_encoder_layers=min(cfg.num_encoder_layers, args.num_layers))
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.kind == "encdec" and (args.continuous or args.model_axis > 1):
        raise NotImplementedError(
            f"{cfg.name}: continuous and expert-parallel serving of an "
            f"encoder-decoder (--continuous, --model-axis > 1) are not "
            f"ported yet (ROADMAP Queue 1 item 8.8)")
    model = build_model(cfg, device=device, seed=args.seed)
    B, S = args.batch, args.prompt_len
    # the knobs: an explicit flag, then the tuned artifact, then the
    # default. Serving never migrates or condenses, so the wire stays flat
    # and the artifact gives the execution knobs and the similarity pair
    serve_knobs = ("exec_mode", "pipeline_chunks", "plan_objective",
                   "hier_dedup", "similarity_backend", "lsh_bits",
                   "wire_dtype")
    tuned = None
    if args.autotune and cfg.uses_moe:
        tuned = obs_at.run_autotune(
            topo=Topology.flat(args.model_axis), out_dir=args.autotune,
            force=args.autotune_force, backend=backend_of(device),
            tokens=B * S, top_k=cfg.moe.top_k, d_model=cfg.d_model,
            d_ff=cfg.moe.d_ff, num_layers=cfg.num_layers, n_slots=B,
            num_experts=cfg.moe.num_experts, group_size=min(128, S),
            # the decode term: one live token a sequence, and the
            # shared-expert FFN the reference's decode overlaps
            decode_tokens=B,
            d_ff_shared=cfg.moe.d_ff * cfg.moe.num_shared_experts)
        print(f"autotune {tuned.key}: {tuned.knobs} modeled "
              f"{tuned.modeled_step_ms:.3f}ms vs default "
              f"{tuned.default_step_ms:.3f}ms", flush=True)
    knobs = obs_at.resolve_knobs({k: getattr(args, k) for k in serve_knobs},
                                 tuned, tunable=set(serve_knobs))
    luffy = LuffyConfig(enable_condensation=False, enable_migration=False,
                        exec_mode=knobs["exec_mode"],
                        pipeline_chunks=knobs["pipeline_chunks"],
                        plan_objective=knobs["plan_objective"],
                        similarity_backend=knobs["similarity_backend"],
                        lsh_bits=knobs["lsh_bits"],
                        condense_reuse=args.condense_reuse,
                        hier_dedup=knobs["hier_dedup"],
                        wire_dtype=knobs["wire_dtype"])
    pdist = single_device()
    if args.model_axis > 1:
        mesh = make_host_mesh(model=args.model_axis)
        pdist = make_dist(mesh, "prefill", B, moe_arch=cfg.uses_moe)
        print(f"mesh {dict(zip(mesh.axis_names, mesh.shape))} (virtual "
              f"ranks); prefill seq_sharded={pdist.seq_sharded}, decode "
              f"as on one device", flush=True)
    chunks = 1
    if cfg.uses_moe:
        piped, plan, _ = schedule_of(
            cfg, luffy, pdist.comm(luffy.comm_mode),
            max(1, B * S // pdist.token_divisor),
            prefill_capacity(cfg, B, S, pdist))
        chunks = plan.n_chunks if piped else 1
    print(f"exec_mode={luffy.exec_mode} pipeline_chunks="
          f"{luffy.pipeline_chunks} chunks={chunks} in the prefill "
          f"plan_objective={luffy.plan_objective} "
          f"similarity_backend={luffy.similarity_backend} "
          f"wire_dtype={luffy.wire_dtype} "
          f"plan_cache={args.plan_cache or 'off'}", flush=True)
    plan_cache = None
    if args.plan_cache:
        from repro_torch.plan.cache import PlanCache
        plan_cache = PlanCache(args.plan_cache)
    trace_out = args.trace_out or ("trace.json" if args.trace else "")
    tracer = None
    if trace_out:
        tracer = obs_trace.activate(obs_trace.Tracer(fence=True))
    registry = None
    if args.metrics_json:
        registry = obs_metrics.MetricsRegistry(luffy=luffy, run_info={
            "launcher": "serve", "arch": args.arch,
            "continuous": bool(args.continuous), "batch": B,
            "prompt_len": S, "gen": args.gen})
    try:
        if args.continuous:
            result = _serve_continuous(args, cfg, luffy, model, plan_cache,
                                       registry, device)
            result.update(arch=cfg.name, device=str(device), batch=B,
                          prompt_len=S, gen=args.gen,
                          model_axis=args.model_axis)
        else:
            result = _serve_fixed(args, cfg, luffy, model, pdist, plan_cache,
                                  registry, device, chunks)
    finally:
        if tracer is not None:
            obs_trace.deactivate()
    result.update(knobs=knobs, tuned=tuned)
    if plan_cache is not None:
        result["plan_cache"] = plan_cache.stats()
        print(f"plan cache: {plan_cache.stats()}")
    if tracer is not None:
        tracer.write(trace_out)
        print(f"trace: {len(tracer.events)} events -> {trace_out}")
    return result


def _serve_fixed(args, cfg, luffy, model, pdist, plan_cache, registry,
                 device, chunks) -> Dict:
    """One fixed batch: the batched prefill (``--prefill batch``), the
    step-wise prompt feed and the greedy decode (an encoder-decoder's
    against the cross K/V its prefill gives)."""
    from repro_torch.serve.engine import write_cross_kv
    B, S = args.batch, args.prompt_len
    s_max = S + args.gen
    r = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(r.integers(1, cfg.vocab_size, (B, S)),
                              dtype=torch.int32, device=device)
    # an encoder-decoder's frames (the frontend stub), drawn after the
    # prompts: [B, S, prefix_dim], the reference's input_specs shape
    enc_input = None
    if cfg.kind == "encdec":
        enc_input = torch.as_tensor(r.standard_normal(
            (B, S, cfg.prefix_dim or cfg.d_model)), dtype=torch.float32,
            device=device)
    ckvs = None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    result: Dict = {"arch": cfg.name, "device": str(device), "batch": B,
                    "prompt_len": S, "gen": args.gen,
                    "model_axis": args.model_axis, "chunks": chunks}
    if plan_cache is not None and args.precompute_plans and cfg.uses_moe:
        from repro_torch.plan.cache import (precompute_decode_plans,
                                            precompute_prefill_plans)
        if args.prefill == "batch":
            key = precompute_prefill_plans(cfg, luffy, pdist, B, S,
                                           plan_cache)
            print(f"precomputed prefill plan: {key}")
        key = precompute_decode_plans(cfg, luffy, B, plan_cache)
        print(f"precomputed decode plan: {key}")

    if args.prefill == "batch":
        for _ in range(N_BATCHED_PREFILLS - 1):             # warm-up
            model.prefill(prompts, s_max, luffy=luffy, dist=pdist,
                          plan_cache=plan_cache, enc_input=enc_input)
        _sync(device)
        t0 = time.perf_counter()
        with obs_trace.phase("prefill_batch", cat="step"):
            logits_pf, kvs = model.prefill(prompts, s_max, luffy=luffy,
                                           dist=pdist, plan_cache=plan_cache,
                                           enc_input=enc_input)
            _sync(device)
        dt = time.perf_counter() - t0
        if enc_input is not None:
            ckvs = [ckv for _, ckv in kvs]
        del kvs
        result.update(prefill_s=dt, prefill_tok_s=B * S / dt,
                      prefill_logits=logits_pf)
        print(f"batched prefill({B}x{S} tokens): {dt:.4f}s "
              f"({B * S / dt:.0f} tok/s)")
        if registry is not None:
            obs_metrics.write_jsonl(args.metrics_json, registry.observe(
                0, {"time_s": dt}, phase="prefill_batch",
                prefill_tokens=B * S))

    enc_len = 0
    if enc_input is not None:
        if ckvs is None:     # --prefill step: one untimed prefill
            kvs = model.prefill(prompts, s_max, luffy=luffy, dist=pdist,
                                enc_input=enc_input)[1]
            ckvs = [ckv for _, ckv in kvs]
            del kvs
        enc_len = S
    cache = model.new_cache(B, s_max, enc_len=enc_len)
    if ckvs is not None:
        write_cross_kv(cache, ckvs)
        del ckvs
    t0 = time.perf_counter()
    step_logits = []
    with obs_trace.phase("prefill_step", cat="step", tokens=S) as sp:
        for t in range(S):
            logits, cache = model.decode_step(cache, prompts[:, t:t + 1],
                                              luffy=luffy,
                                              plan_cache=plan_cache)
            step_logits.append(logits)
        logits = sp.fence(logits)
    _sync(device)
    result["prompt_feed_s"] = time.perf_counter() - t0
    print(f"prefill({S} tokens): {result['prompt_feed_s']:.3f}s")

    out, gen_logits = [], []
    t0 = time.perf_counter()
    for i in range(args.gen):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out.append(nxt[:, 0])
        ts = time.perf_counter()
        with obs_trace.phase("decode", cat="step", step=i) as sp:
            logits, cache = model.decode_step(cache, nxt, luffy=luffy,
                                              plan_cache=plan_cache)
            logits = sp.fence(logits)
        gen_logits.append(logits)
        if registry is not None:
            obs_metrics.write_jsonl(args.metrics_json, registry.observe(
                i + 1, {"time_s": time.perf_counter() - ts,
                        "generated_tokens": B}))
    _sync(device)
    dt = time.perf_counter() - t0
    tokens = (torch.stack(out, 1) if out
              else torch.zeros((B, 0), dtype=torch.int32, device=device))
    result.update(decode_s=dt, decode_ms_per_step=dt / max(args.gen, 1) * 1e3,
                  tokens=tokens.cpu(), step_logits=step_logits,
                  gen_logits=gen_logits)
    if device.type == "cuda":
        result["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
    n_tok = int(tokens.numel())
    print(f"decode: {n_tok} tokens in {dt:.3f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s batch={B}, "
          f"{result['decode_ms_per_step']:.3f} ms/step)")
    print("sample token ids:", tokens[0, :10].tolist() if n_tok else [])
    return result


if __name__ == "__main__":
    main()
