"""``python -m repro_torch.analysis`` — the port's analysis gate.

  python -m repro_torch.analysis --check [--sanitizer] [--json FILE]
  python -m repro_torch.analysis --check --device cpu
  python -m repro_torch.analysis --list-rules

Runs the port's lint (``analysis.lint``), holds every case of
``analysis.cases`` against ``launch_check`` and checks that the cases
launch every instance of every ``.cu`` dispatch; then, on the card, the
kernel proofs (``analysis.proofs``: every case of the ten wrappers, one
child process a family under a watchdog) and, with ``--sanitizer``, the
families under ``compute-sanitizer`` (``analysis.sanitizer``). Prints one
``file:line rule message`` line a finding and the proof matrix; with
``--check`` a finding makes the exit code non-zero. The default device is
the card, and without one it exits 2 unless ``--device cpu`` is given;
on the CPU nothing is launched and every cell of the matrix reads
``untested``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

from . import cases as C
from . import launch_check, lint, proofs, registry, sanitizer


def static_findings(cs) -> list:
    """The cases against ``launch_check`` and the dispatch coverage."""
    out = []
    for w, miss in sorted(C.uncovered(cs).items()):
        for tok in sorted(miss):
            out.append(proofs.Finding(
                f"{w}/dispatch", launch_check.RULE_INSTANCE,
                f"no case launches {tok!r} of {C.SOURCE[w]}.cu",
                f"src/repro_torch/kernels/csrc/{C.SOURCE[w]}.cu", 0))
    on_card = torch.cuda.is_available()
    for c in cs:
        for v in launch_check.check_launch(c.wrapper, geometry=c.geometry,
                                           on_card=on_card, **c.shape):
            out.append(proofs.Finding(
                c.id, v.rule, v.message,
                f"src/repro_torch/kernels/csrc/{c.source}.cu", 0))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description="the port's kernel proofs, "
                                             "launch checks and lint")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero on any finding")
    ap.add_argument("--sanitizer", action="store_true",
                    help="also run each family under compute-sanitizer")
    ap.add_argument("--json", metavar="FILE", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card: launch the proofs) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--root", default=".",
                    help="the repository root to lint")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, desc in registry.all_rules().items():
            print(f"{rule:<26} {desc}")
        return 0
    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("repro_torch.analysis: no CUDA device; the proofs launch the "
              "kernels on the card (pass --device cpu for the static "
              "checks alone)", file=sys.stderr)
        return 2
    cs = C.cases(seed=args.seed)
    findings = [proofs.Finding("lint", f.rule, f.message, f.path, f.line)
                for f in lint.lint_tree(args.root)]
    findings += static_findings(cs)
    results, notes, san = [], [], None
    if on_card:
        results = proofs.run(args.device, seed=args.seed)
        findings += [f for r in results for f in r.findings]
        findings += proofs.cross_order(results)
        if args.sanitizer:
            san = sanitizer.run(seed=args.seed)
            if not san["available"]:
                notes.append("compute-sanitizer: not found in the CUDA "
                             "toolkit or on the PATH")
            for run in san["runs"]:
                findings += sanitizer.by_wrapper(run.findings)
                notes += [f"{run.family} {run.tool}: {n}"
                          for n in run.notes]
    else:
        results = [proofs.CaseResult(c.id, c.wrapper, [], trips=c.trips)
                   for c in cs]
    matrix = proofs.proof_matrix(results, [f for f in findings
                                           if "/" in f.case])
    for f in findings:
        print(f.format())
    for n in notes:
        print(f"note: {n}")
    print(proofs.format_proof_matrix(matrix))
    n_ring = sum(1 for c in cs if c.trips)
    print(f"repro_torch.analysis: {len(cs)} cases ({n_ring} ring), "
          f"{len(findings)} finding{'s' if len(findings) != 1 else ''}, "
          f"device {torch.cuda.get_device_name(0) if on_card else 'cpu'}",
          file=sys.stderr)
    if args.json:
        report = {
            "device": torch.cuda.get_device_name(0) if on_card else "cpu",
            "findings": [dataclasses.asdict(f) for f in findings],
            "count": len(findings), "rules": registry.all_rules(),
            "properties": list(proofs.PROPERTIES), "proof_matrix": matrix,
            "cases": [r.to_json() for r in results], "notes": notes,
            "sanitizer": None if san is None else {
                "available": san["available"], "exe": san.get("exe"),
                "runs": [dataclasses.asdict(r) for r in san["runs"]]}}
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=1)
    return 1 if (findings and args.check) else 0


if __name__ == "__main__":
    sys.exit(main())
