"""Published-checkpoint parity harness of the port.

Counterpart of mvlt_tpu/eval/parity.py. The reference's README publishes
zero-shot retrieval and recognition numbers from two checkpoints
(checkpoint_retrieval.pth, checkpoint_recognition.pth, loaded at
main_vl.py:327-346). With those files and a real Fashion-Gen tree this
drives the port's command line as the README's flow runs
(``--eval-retrieval-{itr,tir} --parity-heads`` and ``--eval-recognition``,
each with ``--resume <pth>``) and holds the metrics to the published ones:

    python -m mvlt_tpu_torch.eval.parity --data-path <fashion_gen_root> \
        [--retrieval-pth checkpoint_retrieval.pth] \
        [--recognition-pth checkpoint_recognition.pth] [--device cuda]

A check whose inputs are absent prints SKIP (exit 0); a metric out of
tolerance fails (exit 1).

Tolerances, fixed here so they cannot be bent after the fact:
  * retrieval acc@k: +/- 0.010 absolute. The protocol divides by a fixed
    1000 (engine_grid_masking.py:393), so scores move in steps of 0.001; the
    budget covers bf16-vs-fp16 logit noise flipping near-tied ranks (a few
    queries) and PIL-dither crop-box deltas.
  * recognition accuracy: +/- 0.005 absolute; macro-F1: +/- 0.010 (macro-F1
    amplifies single-sample flips in rare classes).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# the reference README's numbers (README.md:42-49, BASELINE.md)
EXPECTED = {
    "retrieval-tir": {"acc@1": 0.346, "acc@5": 0.780, "acc@10": 0.895},
    "retrieval-itr": {"acc@1": 0.331, "acc@5": 0.772, "acc@10": 0.911},
    "recognition": {
        "sup_accuracy": 0.9825996064928677,
        "sup_macro_f1": 0.8954719842489123,
        "sub_accuracy": 0.9356554353172651,
        "sub_macro_f1": 0.8285927576055913,
    },
}
TOL = {"retrieval": 0.010, "accuracy": 0.005, "macro_f1": 0.010}


def _check(name: str, got: dict, want: dict, tol_of) -> list:
    fails = []
    for k, exp in want.items():
        tol = tol_of(k)
        val = float(got[k])
        ok = abs(val - exp) <= tol
        print(f"  {name} {k}: got {val:.4f}  expected {exp:.4f} "
              f"(+/-{tol})  {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            fails.append(f"{name}.{k}: {val:.4f} vs {exp:.4f}")
    return fails


def main(argv=None) -> int:
    p = argparse.ArgumentParser("published-checkpoint parity harness (PyTorch)")
    p.add_argument("--data-path", required=True,
                   help="Fashion-Gen root (retrieve_ITR/, retrieve_TIR/, "
                        "extracted_valid_images/, full_valid_info_PAI/)")
    p.add_argument("--retrieval-pth", default="checkpoints/checkpoint_retrieval.pth")
    p.add_argument("--recognition-pth", default="checkpoints/checkpoint_recognition.pth")
    p.add_argument("--config", default="configs/pretrain_exp21.py")
    p.add_argument("--expected-override", default="",
                   help="JSON file overriding EXPECTED (test fixtures)")
    p.add_argument("--skip-retrieval", action="store_true")
    p.add_argument("--skip-recognition", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda or cpu)")
    args = p.parse_args(argv)

    expected = EXPECTED
    if args.expected_override:
        with open(args.expected_override) as f:
            expected = json.load(f)

    from mvlt_tpu_torch.cli import main as cli_main

    fails: list = []
    ran = 0

    def cli(extra):
        return cli_main(["--config", args.config, "--data-path", args.data_path,
                         "--device", args.device] + extra)

    if not args.skip_retrieval:
        if not os.path.exists(args.retrieval_pth):
            print(f"SKIP retrieval parity: checkpoint not found at "
                  f"{args.retrieval_pth} (download checkpoint_retrieval.pth "
                  f"as the reference README says and pass --retrieval-pth)",
                  flush=True)
        elif not os.path.isdir(os.path.join(args.data_path, "retrieve_ITR")):
            print(f"SKIP retrieval parity: {args.data_path}/retrieve_ITR "
                  f"missing (needs the reference's pickled 101-candidate "
                  f"bundles)", flush=True)
        else:
            for direction in ("itr", "tir"):
                got = cli([f"--eval-retrieval-{direction}", "--parity-heads",
                           "--resume", args.retrieval_pth])
                fails += _check(f"retrieval-{direction}", got,
                                expected[f"retrieval-{direction}"],
                                lambda k: TOL["retrieval"])
                ran += 1

    if not args.skip_recognition:
        if not os.path.exists(args.recognition_pth):
            print(f"SKIP recognition parity: checkpoint not found at "
                  f"{args.recognition_pth}", flush=True)
        elif not os.path.isdir(os.path.join(args.data_path, "extracted_valid_images")):
            print(f"SKIP recognition parity: {args.data_path}/"
                  f"extracted_valid_images missing", flush=True)
        else:
            got = cli(["--eval-recognition", "--resume", args.recognition_pth])
            fails += _check(
                "recognition", got, expected["recognition"],
                lambda k: TOL["accuracy"] if k.endswith("accuracy") else TOL["macro_f1"])
            ran += 1

    if fails:
        print(f"PARITY FAIL ({len(fails)} metric(s) out of tolerance):", flush=True)
        for f in fails:
            print(f"  {f}", flush=True)
        return 1
    print(f"PARITY {'OK' if ran else 'SKIPPED'} "
          f"({ran} protocol run(s) checked)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
