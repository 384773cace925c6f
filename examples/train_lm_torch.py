"""End-to-end training drill through the port's driver
(``repro_torch.launch.train``), as ``examples/train_lm.py`` runs the JAX
package's: 120 steps of granite-3-2b's smoke config with microbatching, a
checkpoint every 40 steps, the preemption guard and the straggler monitor,
then a simulated restart that restores the latest checkpoint and continues
to 200. Runs on the card by default:

  PYTHONPATH=src python examples/train_lm_torch.py [--device cpu]
"""
import argparse
import shutil
import tempfile

from repro_torch.launch import train as train_driver


def drill_args(ckpt_dir: str, steps: int) -> list[str]:
    return [
        "--arch", "granite-3-2b", "--smoke",
        "--steps", str(steps), "--seq-len", "64", "--batch", "8",
        "--microbatches", "2", "--lr", "3e-3",
        "--ckpt-dir", ckpt_dir, "--ckpt-every", "40",
        "--log-every", "20",
    ]


def drill(ckpt_dir: str, device: str = "cuda"):
    """Both phases in ``ckpt_dir``; returns the state after each."""
    # phase 1: train 120 steps, checkpoint every 40
    first = train_driver.main(drill_args(ckpt_dir, 120), device=device)
    # phase 2: simulate a restart — the driver restores from the latest
    # checkpoint and continues to 200
    print("\n--- simulated restart (restore from checkpoint) ---")
    second = train_driver.main(drill_args(ckpt_dir, 200), device=device)
    return first, second


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        drill(ckpt_dir, args.device)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
