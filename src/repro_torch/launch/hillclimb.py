"""Perf hillclimbing driver: ``repro.launch.hillclimb`` in PyTorch. Re-runs
a dry-run cell (``launch.dryrun``) under named optimization variants and
records before/after roofline terms.

Variants (composable):
  zero1      — hoist FSDP param all-gather out of the microbatch loop
  bf16       — bf16 activations + compute-dtype weight casts
  attn_pairs — triangular pair-scan attention (exact causal FLOPs)
  chunks<q>x<k> — attention chunk shape override

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch granite-3-2b \\
      --shape train_4k --variants baseline zero1 zero1+bf16
"""
import argparse
import json
import os
import traceback

from repro_torch.launch.dryrun import dryrun_cell


def variant_kwargs(variant: str) -> dict:
    kw: dict = {"arch_overrides": {}, "zero1": False}
    for part in variant.split("+"):
        if part == "baseline":
            continue
        elif part == "zero1":
            kw["zero1"] = True
        elif part == "bf16":
            kw["arch_overrides"]["activation_dtype"] = "bfloat16"
        elif part == "attn_pairs":
            kw["arch_overrides"]["attn_pairs"] = True
        elif part.startswith("chunks"):
            qc, kc = part[len("chunks"):].split("x")
            kw["arch_overrides"]["q_chunk"] = int(qc)
            kw["arch_overrides"]["kv_chunk"] = int(kc)
        elif part.startswith("remat-"):
            kw["arch_overrides"]["remat"] = part.split("-", 1)[1]
        elif part == "repkv":
            kw["arch_overrides"]["replicate_kv"] = True
        elif part.startswith("padheads"):
            # pad head counts up to a mesh-divisible multiple (extra wo rows
            # are zero in a real deployment -> numerically exact); removes
            # the replicated-attention fallback for e.g. 56- or 40-head archs
            n = int(part[len("padheads"):])
            kw["arch_overrides"]["num_heads"] = n
            # MHA archs pad kv heads alongside
            kw["_pad_kv"] = n
        else:
            raise ValueError(f"unknown variant part '{part}'")
    return kw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", nargs="+", default=["baseline"])
    ap.add_argument("--out", default="experiments/perf")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    for variant in args.variants:
        tag = f"{args.arch}_{args.shape}_{variant}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") == "ok":
                    print(f"skip existing {tag}")
                    continue
        try:
            kw = variant_kwargs(variant)
            pad_kv = kw.pop("_pad_kv", None)
            if pad_kv is not None:
                from repro_torch.configs.registry import get_arch

                base = get_arch(args.arch)
                if base.num_kv_heads == base.num_heads:  # MHA: pad kv too
                    kw["arch_overrides"]["num_kv_heads"] = pad_kv
            rec = dryrun_cell(
                args.arch, args.shape, multi_pod=False, **kw
            )
            rec["variant"] = variant
        except Exception as e:
            rec = {"arch": args.arch, "shape": args.shape, "variant": variant,
                   "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()[-3000:]}
            print(f"FAIL {tag}: {e!r}")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
