"""The modeled dry run (counterpart of the modeled half of
``repro/launch/dryrun.py``): the per-step communication-traffic and
overlap ledger of one (architecture, input shape, mesh layout), priced
analytically, with the knobs resolved as the launchers resolve them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch moe-gpt2 \\
        --shape train_4k [--multi-pod] [--nodes N] \\
        [--exec-mode {sync,pipeline,decode_overlap}] [--pipeline-chunks N] \\
        [--plan-objective {traffic,overlap,replicate}] \\
        [--plan-reuse {off,signature,always}] \\
        [--similarity-backend {exact,lsh}] [--lsh-bits N] \\
        [--condense-reuse {off,signature,always}] [--hier-dedup {off,on}] \\
        [--wire-dtype {f32,bf16,f8e4m3}] \\
        [--autotune DIR [--autotune-force]] [--calibration FILE] \\
        [--metrics-json PATH] [--out PATH]

The mesh is the reference's production layout (16 x 16, or 2 x 16 x 16
with ``--multi-pod``; ``--nodes N`` splits the model axis into N nodes),
with no device behind it: nothing is lowered, compiled or run, and the
record's ``status`` is ``"modeled"``; at ``long_500k`` an arch that
cannot decode it (``ModelConfig.supports_long_decode``: full attention)
gets the reference's ``"skipped"`` record with its reason instead. The
ledger prices the expert FFN at the card's bf16 tensor-core peak
(``launch.mesh.PEAK_FLOPS_BF16``), or at a measured calibration's FFN
speed (``--calibration``, an artifact of
:mod:`repro_torch.obs.calibrate` or of the reference's). Knob
precedence: an explicit flag, then the tuned artifact (``--autotune``),
then the default (:func:`repro_torch.obs.autotune.resolve_knobs`); the
wire's ``comm_mode`` follows the layout. The reference's compile half
(memory analysis, HLO collectives) has no counterpart here.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional, Sequence

from repro_torch.launch.mesh import PEAK_FLOPS_BF16

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun"


def comm_traffic_ledger(cfg, shape, mesh, *, nodes: int = 0,
                        exec_chunks: int = 0, plan_reuse: str = "off",
                        similarity_backend: str = "exact",
                        lsh_bits: int = 8, condense_reuse: str = "off",
                        hier_dedup: str = "off",
                        wire_dtype: str = "f32",
                        condense_group: int = 128,
                        calibration=None,
                        autotune_applied: bool = False,
                        peak_flops: float = PEAK_FLOPS_BF16):
    """Analytic per-step dispatch traffic split by link tier, plus the
    modeled compute/communication overlap, one
    :func:`repro_torch.plan.estimate.estimate_exchange` call per
    condensation rate bucket (the estimate the plan builder attaches to
    every plan): bytes a flat all-to-all ships across nodes against the
    hierarchical path after per-node dedup, and the pipelined MoE
    sublayer at exactly ``exec_chunks`` chunks when the run pipelines,
    else at the 1..16 planning optimum (dispatch and combine priced on
    the hier bytes, the expert FFN at ``peak_flops``). On a flat mesh the
    ledger prices a ``nodes``-way split of the model axis (default 4).
    Then the wire, plan-reuse, condensation, decode and autotune
    sections. Returns None where the split does not divide the model
    axis, the topology is not hierarchical or the arch has no MoE.

    ``calibration`` (a :class:`repro_torch.obs.calibrate.Calibration`)
    swaps every hand-set pricing constant for the measured fit: link
    bandwidths and latencies, the per-chunk overhead, the FFN speed (in
    place of ``peak_flops``) and the planning and similarity costs. The
    JSON carries ``schema_version``
    (``repro_torch.obs.metrics.COMM_LEDGER_SCHEMA_VERSION``)."""
    from repro_torch.comm.dtypes import SCALE_BLOCK, wire_precision, \
        wire_row_bytes
    from repro_torch.comm.ledger import expected_dedup_factor
    from repro_torch.comm.topology import Topology
    from repro_torch.condense.backends import expected_measured_pairs
    from repro_torch.core.moe_layer import capacity_for
    from repro_torch.launch.mesh import topology_for_mesh
    from repro_torch.obs.autotune import autotune_config
    from repro_torch.obs.metrics import COMM_LEDGER_SCHEMA_VERSION
    from repro_torch.plan.estimate import (estimate_exchange,
                                           estimate_planning_ms,
                                           estimate_revalidate_ms,
                                           estimate_similarity_ms)
    from repro_torch.sched import plan_chunks
    from repro_torch.sched.cost import decode_combine_ms, decode_step_ms
    names = tuple(mesh.axis_names)
    if "node" in names:
        topo = topology_for_mesh(mesh)
    else:
        M = dict(zip(names, mesh.devices.shape)).get("model", 1)
        nodes = nodes or min(4, M)
        if M % nodes or M // nodes < 1:
            return None
        topo = Topology(nodes, M // nodes)
    if not topo.hierarchical or not cfg.uses_moe:
        return None
    if calibration is not None:
        topo = calibration.topology(topo)
    peak = (calibration.ffn_speed if calibration is not None
            else peak_flops)
    est_kw = (calibration.estimate_kwargs() if calibration is not None
              else {})
    tokens = shape.global_batch * shape.seq_len
    k = cfg.moe.top_k
    out = {"schema_version": COMM_LEDGER_SCHEMA_VERSION,
           "calibration": (calibration.key if calibration is not None
                           else None),
           "topology": {"nodes": topo.num_nodes,
                        "devices_per_node": topo.devices_per_node,
                        "bw_ratio": topo.bw_ratio},
           "dedup_factor": expected_dedup_factor(k, topo),
           "buckets": {}}
    for r in (0.0, 0.25, 0.5):
        # dispatch ~ combine on the hier bytes; the expert FFN at the
        # roofline (or the measured fit) spread over the expert shards
        ffn_flops = (tokens * (1.0 - r) * k * 4 * cfg.d_model
                     * cfg.moe.d_ff * cfg.num_layers)
        ffn_ms = ffn_flops / (peak * topo.num_devices) * 1e3
        if exec_chunks > 0:      # the executed configuration, with the
            # executor's own capacity clipping (capacity / 8)
            cap = capacity_for(cfg.moe, tokens // mesh.devices.size,
                               cfg.moe.num_experts, rate=r)
            chunks = plan_chunks(cap, exec_chunks).n_chunks
        else:                    # planning search
            chunks = None
        est = estimate_exchange(tokens, k, cfg.d_model, topo=topo,
                                r_cond=r, num_layers=cfg.num_layers,
                                ffn_ms=ffn_ms, chunks=chunks,
                                wire_dtype=wire_dtype, **est_kw)
        out["buckets"][str(r)] = {
            "flat": {"intra_bytes": est.flat_intra_dispatch_bytes,
                     "inter_bytes": est.flat_inter_dispatch_bytes,
                     "time_s": est.flat_dispatch_ms / 1e3},
            "hier": {"intra_bytes": est.intra_dispatch_bytes,
                     "inter_bytes": est.inter_dispatch_bytes,
                     "time_s": est.dispatch_ms / 1e3},
            "overlap": {"ffn_ms": est.ffn_ms, "sync_ms": est.sync_ms,
                        "pipelined_ms": est.overlap_ms,
                        "chunks": est.chunks,
                        "speedup": est.speedup},
        }

    # ---- wire precision: the bucket bytes above are already priced at
    # this dtype; the per-row arithmetic, and the shipped inter-node bytes
    # of each execution mode (equal: the dedup wire is mode-independent)
    b0w = out["buckets"]["0.0"]
    shipped = (b0w["hier"]["inter_bytes"] if hier_dedup == "on"
               else b0w["flat"]["inter_bytes"])
    out["wire"] = {
        "dtype": wire_dtype,
        "precision": wire_precision(cfg.d_model, wire_dtype, 4),
        "row_bytes": wire_row_bytes(cfg.d_model, wire_dtype, 4),
        "row_bytes_f32": (cfg.d_model + 2) * 4,
        "scale_block": SCALE_BLOCK,
        "shipped_vanilla_bytes": shipped,
        "shipped_migrate_bytes": shipped,
        "shipped_pipelined_bytes": shipped,
    }

    # ---- plan reuse, under stable routing: one replan a forward seeds
    # the carried plan, every later MoE sublayer revalidates
    n_moe = sum(1 for i in range(cfg.num_layers)
                if cfg.ffn_kind(i) == "moe")
    M = topo.num_devices
    # migrate-mode training shards the batch over the whole mesh, so the
    # planner sees M * (global_batch / mesh size) slots
    n_seq_local = max(1, shape.global_batch // mesh.devices.size)
    n_slots = M * n_seq_local
    built = n_moe if plan_reuse == "off" else min(1, n_moe)
    reused = n_moe - built
    plan_ms = (estimate_planning_ms(n_slots, M,
                                    step_us=calibration.plan_step_us)
               if calibration is not None
               else estimate_planning_ms(n_slots, M))
    reval_ms = estimate_revalidate_ms(n_slots, M)
    # "always" trusts the carry without the signature compare
    checks = reused if plan_reuse == "signature" else 0
    out["plan_reuse"] = {
        "mode": plan_reuse,
        "moe_sublayers": n_moe,
        "n_slots": n_slots,
        "plans_built_per_step": built,
        "plans_reused_per_step": reused,
        "revalidation_mismatches": 0,      # stable-routing model
        "planning_ms_per_plan": plan_ms,
        "revalidate_ms_per_check": reval_ms,
        "planning_ms_saved_per_step": reused * plan_ms
        - checks * reval_ms,
    }

    # ---- condensation: the backends' measured-pair model, the dedup
    # wire's bytes and the condense-plan builds under stable routing
    G = min(condense_group, shape.seq_len)
    tokens_l = max(1, tokens // mesh.devices.size)   # per-device groups
    pairs = {b: expected_measured_pairs(
        tokens_l, G, cfg.moe.num_experts, backend=b, lsh_bits=lsh_bits)
        * mesh.devices.size
        for b in ("exact", "lsh")}
    # one build runs per device in parallel: price the per-device share
    sim_kw = ({"speed": calibration.sim_speed}
              if calibration is not None else {})
    sim_ms = {b: estimate_similarity_ms(p / mesh.devices.size,
                                        cfg.d_model, **sim_kw)
              for b, p in pairs.items()}
    b0 = out["buckets"]["0.0"]
    c_built = n_moe if condense_reuse == "off" else min(1, n_moe)
    c_reused = n_moe - c_built
    out["condensation"] = {
        "backend": similarity_backend,
        "group_size": G,
        "lsh_bits": lsh_bits,
        "measured_pairs_per_step": pairs,
        "similarity_ms_per_build": sim_ms,
        "dedup_wire": {
            "enabled": hier_dedup == "on",
            "modeled_inter_bytes": b0["hier"]["inter_bytes"],
            "flat_inter_bytes": b0["flat"]["inter_bytes"],
            "shipped_inter_bytes": (b0["hier"]["inter_bytes"]
                                    if hier_dedup == "on" else
                                    b0["flat"]["inter_bytes"]),
        },
        "condense_plan": {
            "mode": condense_reuse,
            "built_per_step": c_built,
            "reused_per_step": c_reused,
            "similarity_ms_saved_per_step":
                c_reused * sim_ms[similarity_backend],
        },
    }

    # ---- decode: one [B, d_model] combine all-reduce per MoE sublayer
    # plus the shared-expert FFN, in order or overlapped, priced as the
    # reference prices them (an arch without shared experts saves
    # nothing). The port's own decode is the one-device one, with no
    # all-reduce to overlap, so it runs "decode_overlap" as sync
    dec_tokens = shape.global_batch          # one live token per sequence
    dec_combine = decode_combine_ms(dec_tokens, cfg.d_model, topo)
    dec_shared = (dec_tokens * 4.0 * cfg.d_model * cfg.moe.d_ff
                  * cfg.moe.num_shared_experts / peak_flops * 1e3)
    dec_sync = decode_step_ms(combine_ms=dec_combine,
                              shared_ffn_ms=dec_shared,
                              overlap=False) * n_moe
    dec_ovl = decode_step_ms(combine_ms=dec_combine,
                             shared_ffn_ms=dec_shared,
                             overlap=True) * n_moe
    out["decode"] = {
        "tokens": dec_tokens,
        "combine_ms": dec_combine,
        "shared_ffn_ms": dec_shared,
        "sync_ms": dec_sync,
        "overlap_ms": dec_ovl,
        "modeled_speedup": dec_sync / max(dec_ovl, 1e-12),
    }

    # ---- autotune: the knob search over this ledger's topology and
    # pricing constants, always modeled; ``applied`` records whether the
    # run resolved a tuned artifact (--autotune)
    tuned = autotune_config(
        topo=topo, tokens=tokens, top_k=k, d_model=cfg.d_model,
        d_ff=cfg.moe.d_ff, num_layers=cfg.num_layers,
        n_moe=max(1, n_moe), n_slots=n_slots,
        num_experts=cfg.moe.num_experts,
        mesh_devices=mesh.devices.size, group_size=G,
        plan_reuse=plan_reuse, condense_reuse=condense_reuse,
        calib=calibration, ffn_speed=peak)
    out["autotune"] = {
        "applied": bool(autotune_applied),
        "key": tuned.key,
        "knobs": dict(tuned.knobs),
        "modeled_step_ms": tuned.modeled_step_ms,
        "default_step_ms": tuned.default_step_ms,
        "modeled_savings_ms": tuned.modeled_savings_ms,
        "candidates": tuned.candidates,
    }
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True,
                    help="one of repro_torch.config.SHAPES")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 layout (default 16 x 16)")
    ap.add_argument("--nodes", type=int, default=0,
                    help="split the model axis into this many nodes "
                         "(comm_mode hier)")
    ap.add_argument("--exec-mode",
                    choices=["sync", "pipeline", "decode_overlap"],
                    default=None,
                    help="MoE schedule the ledger prices (default sync)")
    ap.add_argument("--pipeline-chunks", type=int, default=None,
                    help="capacity chunks of --exec-mode pipeline (default "
                         "4; under --plan-objective overlap the "
                         "estimate's count)")
    ap.add_argument("--plan-objective", default=None,
                    choices=["traffic", "overlap", "replicate"],
                    help="migration planner objective (default traffic)")
    ap.add_argument("--plan-reuse", default="off",
                    choices=["off", "signature", "always"],
                    help="the plan_reuse section's modeled mode")
    ap.add_argument("--similarity-backend", default=None,
                    choices=["exact", "lsh"],
                    help="condensation similarity backend (default exact)")
    ap.add_argument("--lsh-bits", type=int, default=None,
                    help="projections per LSH bucket code (default 8)")
    ap.add_argument("--condense-reuse", default="off",
                    choices=["off", "signature", "always"],
                    help="the condensation section's modeled reuse mode")
    ap.add_argument("--hier-dedup", default=None, choices=["off", "on"],
                    help="the deduplicated hier wire (needs --nodes > 1; "
                         "default off)")
    ap.add_argument("--wire-dtype", default=None,
                    choices=["f32", "bf16", "f8e4m3"],
                    help="precision rows cross nodes at (default f32)")
    ap.add_argument("--autotune", default="",
                    help="TunedConfig artifact directory: load the tuned "
                         "knobs for this layout's topology or search and "
                         "keep them, then fill every knob no flag set")
    ap.add_argument("--autotune-force", action="store_true",
                    help="search again even when a valid artifact exists")
    ap.add_argument("--calibration", default="",
                    help="a calibration artifact (*.calib.json): price the "
                         "ledger with the measured fit")
    ap.add_argument("--metrics-json", default="",
                    help="also append the flattened comm_ledger as one "
                         "metrics record (JSONL) here")
    ap.add_argument("--out", default="",
                    help="record path (default artifacts/dryrun/"
                         "<arch>__<shape>__<layout>.json)")
    return ap.parse_args(argv)


def _layout_tag(args) -> str:
    """The record's layout tag: the mesh and what the flags pinned."""
    from repro_torch.config import resolve_pipeline_chunks
    tag = "2x16x16" if args.multi_pod else "16x16"
    if args.nodes > 1:
        tag += f"__hier{args.nodes}"
    if args.exec_mode == "pipeline":
        chunks = (args.pipeline_chunks if args.pipeline_chunks is not None
                  else resolve_pipeline_chunks(
                      None, args.plan_objective or "traffic"))
        tag += f"__pipe{chunks}"
    if args.plan_objective not in (None, "traffic"):
        tag += f"__{args.plan_objective}"
    if args.plan_reuse != "off":
        tag += f"__reuse-{args.plan_reuse}"
    if args.similarity_backend not in (None, "exact"):
        tag += f"__{args.similarity_backend}"
    if args.condense_reuse != "off":
        tag += f"__creuse-{args.condense_reuse}"
    if args.hier_dedup == "on":
        tag += "__dedup"
    if args.wire_dtype not in (None, "f32"):
        tag += f"__wd-{args.wire_dtype}"
    if args.autotune:
        tag += "__autotuned"
    return tag


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Price one (arch, shape, layout); writes and returns the record."""
    args = parse_args(argv)
    from repro_torch.config import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import production_layout, topology_for_mesh
    from repro_torch.obs import autotune as obs_at
    from repro_torch.obs.calibrate import Calibration

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    calibration = None
    if args.calibration:
        calibration = Calibration.from_json(
            Path(args.calibration).read_text())
        if calibration is None:
            raise ValueError(
                f"unreadable calibration artifact: {args.calibration} "
                "(wrong magic, schema drift, or malformed)")
    mesh = production_layout(multi_pod=args.multi_pod, nodes=args.nodes)
    cli = {"exec_mode": args.exec_mode,
           "pipeline_chunks": args.pipeline_chunks,
           "plan_objective": args.plan_objective,
           "similarity_backend": args.similarity_backend,
           "lsh_bits": args.lsh_bits, "hier_dedup": args.hier_dedup,
           "wire_dtype": args.wire_dtype}
    tuned = None
    if args.autotune and cfg.uses_moe:
        at_topo = topology_for_mesh(mesh)
        n_moe = sum(1 for i in range(cfg.num_layers)
                    if cfg.ffn_kind(i) == "moe")
        n_seq = max(1, shape.global_batch // mesh.devices.size)
        tuned = obs_at.run_autotune(
            topo=at_topo, out_dir=args.autotune, force=args.autotune_force,
            tokens=shape.global_batch * shape.seq_len,
            top_k=cfg.moe.top_k, d_model=cfg.d_model, d_ff=cfg.moe.d_ff,
            num_layers=cfg.num_layers, n_moe=max(1, n_moe),
            n_slots=at_topo.num_devices * n_seq,
            num_experts=cfg.moe.num_experts,
            mesh_devices=mesh.devices.size,
            group_size=min(128, shape.seq_len),
            plan_reuse=args.plan_reuse,
            condense_reuse=args.condense_reuse, calib=calibration,
            ffn_speed=PEAK_FLOPS_BF16)
        print(f"autotune {tuned.key}: {tuned.knobs} modeled "
              f"{tuned.modeled_step_ms:.3f}ms vs default "
              f"{tuned.default_step_ms:.3f}ms")
    # the wire's comm_mode is structural: the layout's --nodes split
    knobs = obs_at.resolve_knobs(
        cli, tuned, tunable=set(obs_at.TUNABLE_KNOBS) - {"comm_mode"},
        comm_mode="hier" if args.nodes > 1 else "flat")
    tag = _layout_tag(args)
    rec = {"arch": args.arch, "shape": args.shape, "mesh": tag,
           "exec_mode": knobs["exec_mode"],
           "plan_objective": knobs["plan_objective"],
           "plan_reuse": args.plan_reuse, "knobs": knobs,
           "autotuned": tuned is not None, "status": "modeled"}
    out = Path(args.out) if args.out else \
        ARTIFACTS / f"{args.arch}__{args.shape}__{tag}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    if args.shape == "long_500k" and not cfg.supports_long_decode:
        # the reference's rule (src/repro/launch/dryrun.py): only an arch
        # with recurrent state or mostly windowed attention decodes 500k
        rec.update(status="skipped", reason="full-attention arch; "
                   "long_500k skipped (DESIGN.md)")
        out.write_text(json.dumps(rec, indent=1))
        print(f"SKIP {args.arch} {args.shape}")
        return rec
    rec["comm_ledger"] = (comm_traffic_ledger(
        cfg, shape, mesh, nodes=args.nodes,
        exec_chunks=(knobs["pipeline_chunks"]
                     if knobs["exec_mode"] == "pipeline" else 0),
        plan_reuse=args.plan_reuse,
        similarity_backend=knobs["similarity_backend"],
        lsh_bits=knobs["lsh_bits"], condense_reuse=args.condense_reuse,
        hier_dedup=knobs["hier_dedup"], wire_dtype=knobs["wire_dtype"],
        calibration=calibration, autotune_applied=tuned is not None)
        if shape.mode == "train" else None)
    out.write_text(json.dumps(rec, indent=1))
    if args.metrics_json and rec["comm_ledger"]:
        from repro_torch.obs import metrics as obs_metrics
        obs_metrics.write_jsonl(args.metrics_json, {
            "schema_version": obs_metrics.METRICS_SCHEMA_VERSION,
            "arch": args.arch, "shape": args.shape, "mesh": tag,
            "metrics": obs_metrics.flatten("comm_ledger",
                                           rec["comm_ledger"])})
    led = rec["comm_ledger"]
    print(f"MODELED {args.arch} {args.shape} {tag}: "
          + (f"autotune {led['autotune']['knobs']} "
             f"{led['autotune']['modeled_step_ms']:.3f}ms"
             if led else "no ledger (not a hierarchical MoE train shape)")
          + f" -> {out}")
    return rec


if __name__ == "__main__":
    main()
