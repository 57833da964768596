"""Training launcher (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch {moe-gpt2,moe-transformerxl,moe-bert-large,olmoe-1b-7b,
                internvl2-2b,seamless-m4t-large-v2,rwkv6-3b} \\
        [--reduced | --num-layers N] --steps N --global-batch B \\
        --seq-len S \\
        [--optimizer {adamw,adafactor,sgd}] \\
        [--model-axis M [--comm-mode {flat,hier}] [--nodes N] \\
         [--hier-dedup {off,on}] [--wire-dtype {f32,bf16,f8e4m3}] \\
         [--wire-error-feedback]] \\
        [--exec-mode {sync,pipeline}] [--pipeline-chunks N] \\
        [--plan-objective {traffic,overlap,replicate}] [--inter-bw B] \\
        [--plan-reuse {off,signature,always}] \\
        [--condense-reuse {off,signature,always}] [--condense-max-age N] \\
        [--similarity-backend {exact,lsh}] [--lsh-bits N] \\
        [--no-condensation] [--no-migration] \\
        [--metrics-json PATH] [--trace] [--trace-out PATH] \\
        [--log-file PATH] [--ckpt DIR [--ckpt-every N]] \\
        [--drift-tolerance T] [--drift-k K] [--mesh {host,none}] \\
        [--calibrate DIR [--recalibrate-on-drift]] \\
        [--autotune DIR [--autotune-force] [--autotune-refine N]] \\
        [--device cpu]

Weights are random, drawn from ``--seed``; batches come from the
synthetic stream (``repro_torch.data.SyntheticLM``). Each step runs the
LUFFY train step (condensation with the adaptive threshold, then
``--optimizer``: AdamW, or Adafactor, whose bf16 momentum and factored
second moment let moe-bert-large train at full width on one 80 GB card,
or SGD with momentum); the
host then updates the EWMA of the condensation rate and, from step 3 on,
picks the rate bucket that sets the next step's dispatch capacity.
``--arch`` takes the archs with f32 parameters: the MoE decoders
(moe-gpt2, moe-transformerxl, moe-bert-large, olmoe-1b-7b) and the dense
ones, internvl2-2b (each batch with a prefix of 256 random patch
embeddings before its tokens), seamless-m4t-large-v2 (each batch with
random encoder frames) and rwkv6-3b (its WKV6 recurrence and the
recurrence's backward in hand-written kernels on the card). A dense step
has no MoE sublayer: no condensation, migration or bucket, and its step
records carry the loss, the optimizer's gauges, the step time, tokens/s
and the peak memory, no MoE field. The archs with bf16 parameters
(yi-34b, stablelm-12b, starcoder2-15b, gemma3-12b,
llama4-maverick-400b-a17b) serve but do not train yet and raise (ROADMAP
Queue 1 item 8.7b), as hymba does (item 8.6).

``--model-axis M > 1`` trains expert-parallel over M virtual ranks held
by this one process (``repro_torch.comm.hierarchical``): the batch
splits over them, each holds E/M experts, sequences migrate between
them (§IV), and the dispatch and combine run flat or two-phase over
``--nodes`` nodes, on the dense or the deduplicated wire, at
``--wire-dtype``. ``--exec-mode pipeline`` runs each MoE exchange as
the chunked pipeline (:mod:`repro_torch.sched`): ``--pipeline-chunks``
chunks of the dispatch capacity (default 4; 0 takes the exchange
estimate's count), each chunk's collectives on a side CUDA stream
against the previous chunk's expert FFN, bit for bit the sync forward;
the launcher prints the resolved count and each step records it. When
the global batch does not split over M, the
sequence does (rank r holds positions [r*S/M, (r+1)*S/M) of every
sequence, the reference's sequence-parallel train shape), and, as in the
reference, condensation and migration are then off (the launcher says
so). ``--plan-reuse`` and ``--condense-reuse`` skip the migration greedy
and the similarity build at MoE sublayers where a carried plan
revalidates; ``--similarity-backend lsh`` measures only the pairs whose
LSH bucket codes collide. ``--wire-error-feedback`` carries each
token's quantization residual on a lossy wire into the next step's
shipped payload (one f32 residual per layer and token, allocated only
when ``--wire-dtype`` is lossy). Each step record carries the per-forward
counts ``plans_built``, ``plans_reused``, ``plan_reuse_mismatch``,
``condense_built`` and ``condense_reused``. ``--plan-objective``
chooses the migration planner's objective: "traffic" (link-cost-weighted
rows), "overlap" (the pipelined exchange's modelled exposed time; its
default ``--pipeline-chunks`` is the estimate's count) or "replicate"
(traffic's plan, plus each node's hottest expert on an intra-node peer's
spare dispatch lane when the model says it pays: the dense wire, ``hier``
with more than one rank a node). ``--inter-bw`` overrides the cross-node
link's planning rate (bytes/s). The reference's default
model axis of 4 is capped by its device count (one device gives one
rank); virtual ranks have no such cap, so the port's default is 1. On
the card (``--device cuda``, the default, which must exist) the expert
FFN, the similarity, the un-condense gather and the dedup pack run in
the hand-written kernels; on the CPU (``--device cpu``) in their plain
versions.

Observability (:mod:`repro_torch.obs`), as the reference's launcher:
every step is one record of the metrics registry (canonical names,
counters accumulated, keys that do not apply to the configuration
null), appended to ``--metrics-json`` as JSONL and written as one JSON
list to ``--log-file`` at the end. ``--trace`` (or ``--trace-out``,
default ``trace.json``) records fenced host spans, ``data`` and ``step``
around each step and the exchange's phases inside it (``plan_build``,
``condense``, ``exchange``, ``dispatch_pack``, ``dispatch``,
``expert_ffn``, ``combine``, ``pipeline_exchange``; once per MoE
sublayer forward, none from the remat recompute), and writes a Chrome
trace. A fence is a device synchronize, so a traced step runs its phases
one after the other; an untraced step makes no extra sync. From step 4
on (after a 3-step warm-up that skips step 0) each record carries the
``residual/step/*`` gauges of the step time against the warm-up's mean
and the drift flag (``--drift-tolerance``, ``--drift-k``). ``--ckpt
DIR`` saves the parameters (:mod:`repro_torch.checkpoint`, in the
reference's stacked-layer layout, so either package restores them)
every ``--ckpt-every`` steps and at the end.

Calibration and tuning (:mod:`repro_torch.obs.calibrate`,
:mod:`repro_torch.obs.autotune`), as the reference's launcher.
``--calibrate DIR`` loads the fit for this topology and backend from
DIR, or measures one (the virtual ranks' collectives, which are copies
in device memory, the chunk overhead, the planner's step, and K2's and
K1's speeds on the card) and keeps it there, before the ranks are set
up: the links, the chunk overhead and the FFN speed are then priced with
it. ``--autotune DIR`` loads or searches the tuned knobs (wire, schedule,
objective, similarity, wire dtype) and fills every knob no flag set: an
explicit flag beats the artifact, which beats the default.
``--autotune-refine N`` re-ranks the artifact's top candidates by the
measured / modeled step time after the warm-up and, when the knobs
change, rebuilds the steps; ``--recalibrate-on-drift`` measures the fit
again (once a run) when the drift detector fires. Under ``--trace`` the
run ends with one probe exchange a device under a ``probe_exchange``
span and a residual record of its expert FFN against the modeled time.
``--mesh none`` trains on one device whatever ``--model-axis`` says;
``--mesh production`` (the reference's 16 x 16 pod) raises: it needs a
data axis, which is not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="moe-gpt2",
                    help="an arch of repro_torch.configs with f32 "
                         "parameters, not the hybrid (the others raise)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-test variant of --arch")
    ap.add_argument("--d-model", type=int, default=256,
                    help="d_model of the --reduced variant")
    ap.add_argument("--layers", type=int, default=2,
                    help="layers of the --reduced variant")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the full-width arch to its first N layers "
                         "(default: its whole depth)")
    ap.add_argument("--experts", type=int, default=0,
                    help="experts of the --reduced variant (default 4)")
    ap.add_argument("--global-batch", type=int, default=0,
                    help="sequences per step (default 8 reduced, else 256)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--mesh", choices=["host", "production", "none"],
                    default="host",
                    help="host: --model-axis virtual ranks; none: one "
                         "device whatever --model-axis says; production "
                         "(the 16 x 16 pod) needs a data axis, which is "
                         "not ported")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="expert-parallel ranks (virtual, in this process)")
    ap.add_argument("--comm-mode", choices=["flat", "hier"], default=None,
                    help="one flat all-to-all or the two-phase (node, "
                         "local) exchange (default flat)")
    ap.add_argument("--nodes", type=int, default=0,
                    help="split the model axis into this many nodes "
                         "(hier without it splits in 2)")
    ap.add_argument("--hier-dedup", choices=["off", "on"], default=None,
                    help="ship one row per (token, destination node); "
                         "needs --comm-mode hier (default off)")
    ap.add_argument("--wire-dtype", choices=["f32", "bf16", "f8e4m3"],
                    default=None,
                    help="precision rows cross nodes at (default f32)")
    ap.add_argument("--exec-mode", choices=["sync", "pipeline"],
                    default=None,
                    help="MoE schedule: dispatch, expert FFN and combine "
                         "in order, or the chunked pipeline with the "
                         "collectives on a side stream (bit for bit the "
                         "sync forward; default sync)")
    ap.add_argument("--pipeline-chunks", type=int, default=None,
                    help="capacity chunks of --exec-mode pipeline, "
                         "clipped to capacity/8 (default 4; 0 takes the "
                         "exchange estimate's count)")
    ap.add_argument("--plan-objective", default=None,
                    choices=["traffic", "overlap", "replicate"],
                    help="migration planner objective: link-cost-weighted "
                         "rows, the pipelined exchange's modelled exposed "
                         "time, or traffic plus intra-node hot-expert "
                         "replicas (default traffic)")
    ap.add_argument("--inter-bw", type=float, default=0.0,
                    help="cross-node link rate (bytes/s) the planner and "
                         "the estimate price (default the planning "
                         "default)")
    ap.add_argument("--plan-reuse", default="off",
                    choices=["off", "signature", "always"],
                    help="cross-layer migration-plan reuse: replan every "
                         "MoE sublayer, revalidate a carried plan by "
                         "routing signature, or trust it")
    ap.add_argument("--similarity-backend", default=None,
                    choices=["exact", "lsh"],
                    help="condensation similarity backend: measure every "
                         "uncertain pair, or only LSH-bucket collisions "
                         "(default exact)")
    ap.add_argument("--lsh-bits", type=int, default=None,
                    help="signed random projections per LSH bucket code "
                         "(default 8)")
    ap.add_argument("--condense-reuse", default="off",
                    choices=["off", "signature", "always"],
                    help="cross-layer condense-plan reuse: rebuild the "
                         "similarity every MoE sublayer, revalidate the "
                         "carried rep map by primary-expert signature, or "
                         "trust it up to the age bound")
    ap.add_argument("--condense-max-age", type=int, default=4,
                    help="staleness bound (sublayers) on a reused condense "
                         "plan")
    ap.add_argument("--no-condensation", action="store_true")
    ap.add_argument("--no-migration", action="store_true",
                    help="keep sequences home (migration is the identity "
                         "on one rank anyway)")
    ap.add_argument("--wire-error-feedback", action="store_true",
                    help="carry each token's wire quantization residual "
                         "into the next step's shipped payload; no effect "
                         "under --wire-dtype f32")
    ap.add_argument("--optimizer", choices=["adamw", "adafactor", "sgd"],
                    default="adamw")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory (the reference's format)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="also checkpoint every N steps (0: at the end "
                         "only)")
    ap.add_argument("--log-file", default="",
                    help="write every step's metrics record as one JSON "
                         "list here at the end")
    ap.add_argument("--metrics-json", default="",
                    help="append one metrics record (JSONL) per step")
    ap.add_argument("--trace", action="store_true",
                    help="fenced spans around each step and the exchange's "
                         "phases; writes a Chrome trace (see --trace-out)")
    ap.add_argument("--trace-out", default="",
                    help="trace JSON path (implies --trace; default "
                         "trace.json)")
    ap.add_argument("--calibrate", default="",
                    help="calibration artifact directory: load the fit for "
                         "this topology and backend or measure and keep "
                         "one, then price links, chunk overhead and the "
                         "FFN speed with it")
    ap.add_argument("--autotune", default="",
                    help="TunedConfig artifact directory: load the tuned "
                         "knobs for this topology and backend or search "
                         "and keep them, then fill every knob no flag set "
                         "(an explicit flag always wins)")
    ap.add_argument("--autotune-force", action="store_true",
                    help="search again even when a valid artifact exists "
                         "(overwrites it)")
    ap.add_argument("--autotune-refine", type=int, default=0,
                    help="after the measured warm-up, re-rank the tuned "
                         "top candidates under the measured / modeled "
                         "step-time ratio (0: off)")
    ap.add_argument("--recalibrate-on-drift", action="store_true",
                    help="when the step-time drift detector fires, measure "
                         "the calibration again (force; needs --calibrate; "
                         "at most once a run)")
    ap.add_argument("--drift-tolerance", type=float, default=1.5,
                    help="drift detector tolerance: an EWMA of measured / "
                         "expected step time outside [1/t, t] is out of "
                         "tolerance")
    ap.add_argument("--drift-k", type=int, default=5,
                    help="consecutive out-of-tolerance steps before the "
                         "drift detector fires")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _trace_probe(cfg, luffy, args, device, tracer, registry) -> Dict:
    """The end-of-run probe of ``--trace``: one exchange on each device
    under a ``probe_exchange`` span, then the residual of its expert FFN
    (the phase one rank's probe prices meaningfully, so the residual
    checks the calibrated FFN speed) and the devices' dispersion, as one
    more metrics record. The measured side is the probe's own
    ``expert_ffn`` span; the train steps' spans come before it."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import monitor as obs_monitor
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.calibrate import probe_exchange_per_device
    S = min(args.seq_len, 64)
    n0 = len(tracer.events)
    with obs_trace.phase("probe", cat="probe"):
        per_dev = probe_exchange_per_device(cfg, luffy, device=device,
                                            seq_len=S)
    ffn = [e["dur"] for e in tracer.events[n0:]
           if e["ph"] == "X" and e["name"] == "expert_ffn"]
    meas = {"expert_ffn": sum(ffn) / len(ffn) / 1e3} if ffn else {}
    rows = S * cfg.moe.top_k
    pred = {"expert_ffn": rows * 4.0 * cfg.d_model * cfg.moe.d_ff
            / luffy.gpu_speed * 1e3}
    res = obs_monitor.ResidualMonitor().observe(args.steps, pred, meas,
                                                per_device_ms=per_dev)
    rec = registry.observe(args.steps, {}, **res)
    if args.metrics_json:
        obs_metrics.write_jsonl(args.metrics_json, rec)
    print(f"probe: {len(per_dev)} devices, dispersion "
          f"{res.get('residual_device_dispersion', 1.0):.2f}x, expert_ffn "
          f"{meas.get('expert_ffn', float('nan')):.3f}ms measured vs "
          f"{pred['expert_ffn']:.3f}ms modeled", flush=True)
    return {"per_device_ms": per_dev, "residual": res, "record": rec}


def _step_line(i: int, m: Dict, rec: Dict, luffy) -> str:
    """An MoE step's line: loss, condensation, bucket, capacity, locality,
    drops, the inter-node bytes where measured, the reuse counts where
    on, the step time."""
    inter = ""
    if (m["inter_bytes_flat"] or 0.0) > 0:
        inter = (f" inter={m['inter_bytes_dedup']:.0f}B"
                 f"/{m['inter_bytes_flat']:.0f}B")
        if m["inter_bytes_shipped"] is not None:
            inter += f" shipped={m['inter_bytes_shipped']:.0f}B"
    if luffy.plan_reuse != "off" or luffy.condense_reuse != "off":
        inter += (f" plans={m['plans_built']:.0f}/{m['plans_reused']:.0f}"
                  f" cplans={m['condense_built']:.0f}/"
                  f"{m['condense_reused']:.0f}")
    return (f"step {i:5d} loss={m['loss']:.4f} "
            f"cond={m['condense_rate']:.4f} bucket={rec['bucket']} "
            f"C={rec['capacity']} local={m['local_frac']:.2f} "
            f"drop=({m['dispatch_drop']:.3f},{m['combine_drop']:.3f})"
            f"{inter} {rec['step_ms']:.1f}ms")


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Train; returns what was measured, per step and in total."""
    args = parse_args(argv)
    from repro_torch import checkpoint, convert, optim, train_lib
    from repro_torch.config import (LuffyConfig, OptimConfig, ShapeConfig,
                                    reduced)
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import make_dist, single_device
    from repro_torch.comm.topology import Topology
    from repro_torch.launch.mesh import make_host_mesh, topology_for_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import build_model, resolve_device
    from repro_torch.obs import autotune as obs_at
    from repro_torch.obs import calibrate as obs_cal
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import monitor as obs_monitor
    from repro_torch.obs import trace as obs_trace
    from repro_torch.plan.exchange import schedule_of

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.num_layers:
        if args.reduced:
            raise ValueError("--num-layers cuts the full-width arch; the "
                             "--reduced variant takes --layers")
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    if args.reduced:
        cfg = reduced(cfg, num_layers=args.layers, d_model=args.d_model,
                      max_experts=args.experts or 4,
                      seq_len_hint=args.seq_len)
    train_lib.check_trainable(cfg)
    gb = args.global_batch or (8 if args.reduced else 256)
    shape = ShapeConfig("train", args.seq_len, gb, "train")
    if args.mesh == "production":
        raise NotImplementedError(
            "--mesh production: the 16 x 16 pod has a data axis of 16, and "
            "a virtual data axis is not ported (ROADMAP Queue 1 item 3d); "
            "--mesh host trains over --model-axis virtual ranks")
    nodes = args.nodes
    if args.comm_mode == "hier" and nodes <= 1:
        nodes = 2                     # hier needs a (node, local) split
    mesh = topo = None
    if args.mesh == "host" and args.model_axis > 1:
        mesh = make_host_mesh(model=args.model_axis, nodes=nodes)
        topo = topology_for_mesh(mesh, inter_bw=args.inter_bw or None)
    base_topo = topo

    # the measured fit, loaded or measured before the dist context, so the
    # migration link costs, the overlap model and the estimate price it
    calib = None
    if args.calibrate:
        calib = obs_cal.run_calibration(mesh, topo, device=device,
                                        out_dir=args.calibrate)
        if topo is not None:
            topo = calib.topology(topo)
        print(f"calibration {calib.key}: intra_bw={calib.intra_bw:.3g}B/s "
              f"inter_bw={calib.inter_bw:.3g}B/s chunk_overhead="
              f"{calib.chunk_overhead_ms:.3g}ms ffn_speed="
              f"{calib.ffn_speed:.3g}FLOP/s sim_speed="
              f"{calib.sim_speed:.3g}FLOP/s", flush=True)

    # the knobs: an explicit flag, then the tuned artifact, then the
    # default
    cli = {k: getattr(args, k) for k in obs_at.TUNABLE_KNOBS}
    explicit = {k for k, v in cli.items() if v is not None}
    n_moe = (sum(1 for i in range(cfg.num_layers)
                 if cfg.ffn_kind(i) == "moe") if cfg.uses_moe else 0)
    at_topo = topo if topo is not None else Topology.flat(1)
    tuned = None
    if args.autotune and cfg.uses_moe:
        tuned = obs_at.run_autotune(
            topo=at_topo, out_dir=args.autotune, force=args.autotune_force,
            backend=obs_cal.backend_of(device), tokens=gb * args.seq_len,
            top_k=cfg.moe.top_k, d_model=cfg.d_model, d_ff=cfg.moe.d_ff,
            num_layers=max(1, n_moe), n_moe=max(1, n_moe), n_slots=gb,
            num_experts=cfg.moe.num_experts,
            mesh_devices=mesh.devices.size if mesh is not None else 1,
            group_size=min(128, args.seq_len), plan_reuse=args.plan_reuse,
            condense_reuse=args.condense_reuse, calib=calib)
        print(f"autotune {tuned.key}: {tuned.knobs} modeled "
              f"{tuned.modeled_step_ms:.3f}ms vs default "
              f"{tuned.default_step_ms:.3f}ms ({tuned.candidates} "
              f"candidates, calibrated={tuned.calibrated})", flush=True)
    knobs = obs_at.resolve_knobs(cli, tuned)

    dist = single_device()
    if mesh is not None:
        dist = make_dist(mesh, "train", gb, moe_arch=cfg.uses_moe,
                         topology=topo)
        print(f"mesh {dict(zip(mesh.axis_names, mesh.shape))} (virtual "
              f"ranks) topology {topo.num_nodes}x{topo.devices_per_node} "
              f"bw_ratio={topo.bw_ratio:.1f} comm_mode={knobs['comm_mode']}",
              flush=True)
        if dist.seq_sharded:
            print(f"global batch {gb} does not split over {args.model_axis} "
                  f"ranks: sequence-sharded, condensation and migration off",
                  flush=True)
    layout_ok = cfg.uses_moe and not dist.seq_sharded
    luffy = LuffyConfig(
        enable_condensation=not args.no_condensation and layout_ok,
        enable_migration=not args.no_migration and layout_ok,
        condense_group=min(128, args.seq_len), combine_slack=2.0,
        comm_mode=knobs["comm_mode"], hier_dedup=knobs["hier_dedup"],
        exec_mode=knobs["exec_mode"],
        pipeline_chunks=knobs["pipeline_chunks"],
        plan_objective=knobs["plan_objective"],
        wire_dtype=knobs["wire_dtype"], plan_reuse=args.plan_reuse,
        similarity_backend=knobs["similarity_backend"],
        lsh_bits=knobs["lsh_bits"],
        condense_reuse=args.condense_reuse,
        condense_reuse_max_age=args.condense_max_age,
        wire_error_feedback=args.wire_error_feedback)
    if calib is not None:
        luffy = calib.apply(luffy)
    ocfg = OptimConfig(name=args.optimizer, lr=args.lr,
                       total_steps=args.steps,
                       warmup_steps=max(2, args.steps // 20))
    model = build_model(cfg, device=device, seed=args.seed)
    params = model.params
    opt_state = optim.init_opt_state(params, ocfg)
    # the residual buffer exists only where a lossy wire can fill it
    use_ef = (luffy.wire_error_feedback and luffy.wire_dtype != "f32"
              and cfg.uses_moe)
    lstate = train_lib.init_luffy_state(
        device, tf.wire_ef_shape(cfg, gb, args.seq_len) if use_ef else None)
    data = SyntheticLM(cfg, shape)
    steps_by_bucket = {}

    def get_step(bucket: int):
        if bucket not in steps_by_bucket:
            cap = (train_lib.capacity_for_bucket(cfg, shape, luffy, bucket,
                                                 dist)
                   if cfg.uses_moe else 8)
            chunks = 1
            if cfg.uses_moe:
                piped, plan, _ = schedule_of(
                    cfg, luffy, dist.comm(luffy.comm_mode),
                    train_lib.tokens_per_device(shape, dist), cap)
                chunks = plan.n_chunks if piped else 1
            steps_by_bucket[bucket] = (
                cap, chunks,
                train_lib.make_train_step(cfg, luffy, ocfg, cap, dist))
        return steps_by_bucket[bucket]

    print(f"exec_mode={luffy.exec_mode} pipeline_chunks="
          f"{luffy.pipeline_chunks} chunks={get_step(0)[1]} at bucket 0 "
          f"plan_objective={luffy.plan_objective}", flush=True)

    trace_out = args.trace_out or ("trace.json" if args.trace else "")
    tracer = None
    if trace_out:
        tracer = obs_trace.activate(obs_trace.Tracer(fence=True))
    registry = obs_metrics.MetricsRegistry(
        luffy=luffy, run_info={"arch": args.arch, "steps": args.steps,
                               "comm_mode": luffy.comm_mode,
                               "exec_mode": luffy.exec_mode,
                               "calibrated": calib is not None,
                               "autotuned": tuned is not None})
    # the residual stream: the expected step time is the mean of a short
    # measured warm-up (steps 1-3); the EWMA detector then flags
    # sustained departures from it
    monitor = obs_monitor.ResidualMonitor(tolerance=args.drift_tolerance,
                                          k=args.drift_k)
    warmup_ms, expected_step_ms = [], None
    recalibrated, probe = False, None

    def save_ckpt(step: int):
        checkpoint.save(args.ckpt, convert.to_reference(params, cfg),
                        step=step)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    bucket, observed_rate = 0, 0.0
    steps, log = [], []
    t_start = time.perf_counter()
    try:
        for i in range(args.steps):
            with obs_trace.phase("data", cat="step"):
                batch = {k: torch.as_tensor(v, device=device)
                         for k, v in data.batch(i).items()}
            cap, chunks, step_fn = get_step(bucket)
            _sync(device)
            t0 = time.perf_counter()
            with obs_trace.phase("step", cat="step", step=i) as sp:
                out = step_fn(params, opt_state, lstate, batch)
                params, opt_state, lstate, m = sp.fence(out)
            _sync(device)
            dt = time.perf_counter() - t0
            m = train_lib.finalize_metrics(m, luffy)
            rec = dict(step=i, step_ms=dt * 1e3,
                       tokens_per_s=gb * args.seq_len / dt, **m)
            if cfg.uses_moe:
                rec.update(bucket=bucket, capacity=cap, chunks=chunks)
            if device.type == "cuda":
                rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated(
                    device)
            if use_ef:
                rec["wire_ef_absmax"] = float(lstate.wire_ef.abs().max())
            steps.append(rec)
            if cfg.uses_moe:
                observed_rate = (0.8 * observed_rate
                                 + 0.2 * m["condense_rate"])
                if luffy.enable_condensation and i >= 3:
                    bucket = train_lib.pick_bucket_host(luffy,
                                                        observed_rate)
            extra = {}
            if expected_step_ms is None:
                if i >= 1:                  # step 0 pays the warm-up
                    warmup_ms.append(dt * 1e3)
                if len(warmup_ms) >= 3:
                    expected_step_ms = sum(warmup_ms) / len(warmup_ms)
                    if tuned is not None and args.autotune_refine > 0 \
                            and not tuned.refined:
                        # re-rank the top candidates under the measured /
                        # modeled step-time ratio
                        ratio = expected_step_ms / max(
                            tuned.modeled_step_ms, 1e-9)
                        refined = obs_at.rerank(
                            tuned, {"step": ratio}, topo=at_topo,
                            chunk_overhead_ms=luffy.chunk_overhead_ms)
                        changed = {k: v for k, v in refined.knobs.items()
                                   if k not in explicit
                                   and v != tuned.knobs.get(k)}
                        tuned = refined
                        if changed:
                            luffy = dataclasses.replace(luffy, **changed)
                            registry.luffy = luffy
                            steps_by_bucket.clear()
                            expected_step_ms = None
                            warmup_ms.clear()
                            print(f"autotune refine @ step {i}: {changed} "
                                  f"(ratio {ratio:.2f})", flush=True)
            else:
                extra = monitor.observe(i, {"step": expected_step_ms},
                                        {"step": dt * 1e3})
                if args.recalibrate_on_drift and args.calibrate \
                        and monitor.drifted and not recalibrated:
                    recalibrated = True
                    print(f"drift @ step {i} (phases "
                          f"{monitor.drifted_phases()}): recalibrating",
                          flush=True)
                    # keyed by the topology the run started from, so the
                    # next run loads the new fit
                    calib = obs_cal.run_calibration(
                        mesh, base_topo, device=device,
                        out_dir=args.calibrate, force=True)
                    luffy = calib.apply(luffy)
                    registry.luffy = luffy
                    steps_by_bucket.clear()
                    monitor.reset()
                    expected_step_ms = None
                    warmup_ms.clear()
            if cfg.uses_moe:
                extra["bucket"] = bucket
            mrec = registry.observe(i, m, time_s=round(dt, 3), **extra)
            log.append(mrec)
            if args.metrics_json:
                obs_metrics.write_jsonl(args.metrics_json, mrec)
            print(_step_line(i, m, rec, luffy) if cfg.uses_moe else
                  f"step {i:5d} loss={m['loss']:.4f} {rec['step_ms']:.1f}ms "
                  f"{rec['tokens_per_s']:.0f}tok/s", flush=True)
            if args.ckpt and args.ckpt_every \
                    and (i + 1) % args.ckpt_every == 0:
                save_ckpt(i + 1)
        if tracer is not None and cfg.uses_moe:
            probe = _trace_probe(cfg, luffy, args, device, tracer, registry)
    finally:
        if tracer is not None:
            obs_trace.deactivate()
    total = time.perf_counter() - t_start
    print(f"done: {args.steps} steps in {total:.1f}s; final loss "
          f"{steps[-1]['loss']:.4f}" if steps else "done: 0 steps")
    if args.ckpt:
        save_ckpt(args.steps)
    if args.log_file:
        Path(args.log_file).write_text(json.dumps(log, indent=1))
    if tracer is not None:
        tracer.write(trace_out)
        st = tracer.summary().get("step", {})
        print(f"trace: {len(tracer.events)} events -> {trace_out} (step "
              f"total {st.get('total_us', 0.0) / 1e3:.1f}ms over "
              f"{st.get('count', 0)} spans)")
    return {"arch": cfg.name, "cfg": cfg, "device": str(device),
            "global_batch": gb, "seq_len": args.seq_len, "steps": steps,
            "total_s": total, "luffy": luffy, "dist": dist,
            "optimizer": ocfg.name, "lstate": lstate, "log": log,
            "tracer": tracer, "calibration": calib, "tuned": tuned,
            "knobs": knobs, "recalibrated": recalibrated, "probe": probe,
            "n_params": sum(p.numel()
                            for _, p in optim.leaves_with_path(params))}


if __name__ == "__main__":
    main()
