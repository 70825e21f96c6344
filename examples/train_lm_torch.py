"""End-to-end LM training driver example on the PyTorch/CUDA port, the twin
of ``examples/train_lm.py``: the qwen3-family smoke config, 200 steps, with
checkpoints (under ``build/``, so a rerun resumes from the last one).

    PYTHONPATH=src python examples/train_lm_torch.py              # on the card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""

import argparse
from pathlib import Path

from repro_torch.launch.train import main

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = ap.parse_args().device

final_loss = main([
    "--arch", "qwen3-4b", "--smoke",
    "--steps", "200",
    "--seq-len", "128",
    "--batch", "8",
    "--ckpt-dir", str(Path(__file__).resolve().parents[1] / "build" / "lm_example_ckpt"),
    "--ckpt-every", "100",
    "--device", device,
])
assert final_loss < 6.0, "loss should fall well below the ~8.1 ln(V) init"
print("training loss fell — end-to-end driver OK")
