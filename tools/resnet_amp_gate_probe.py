"""The loss trajectory of ``chip_smoke.py``'s ``gluon_resnet_amp`` cell in
fresh processes, each after ``train_resnet_bf16`` as in the whole script
(each process autotunes cuDNN anew, so each may choose other algorithms).

Run on a CUDA card from the repository's root::

    python3 tools/resnet_amp_gate_probe.py [RUNS]

Prints one JSON line a run (the bf16 cell's losses, the AMP cell's
losses, its gate and images/s) and a summary line: the AMP cell's loss
after step 7 (where the gate read it before) and after its last step.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ctx = {"smi": "", "launches": {}}
bf16 = cs.phase_train_resnet_bf16(torch, ctx)
ctx.pop("resnet_bfloat16")
torch.cuda.empty_cache()
amp = cs.phase_gluon_resnet_amp(torch, ctx)
print(json.dumps({"bf16_losses": bf16["losses"], "amp_ok": amp["ok"],
                  "amp_losses": amp["losses"],
                  "images_per_s": amp["images_per_s"]}))
'''


def main() -> int:
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    at7, last = [], []
    for run in range(runs):
        out = subprocess.run([sys.executable, "-c", CHILD, ROOT],
                             capture_output=True, text=True, timeout=300)
        if out.returncode:
            print(out.stderr[-2000:], file=sys.stderr)
            return 1
        line = json.loads(out.stdout.strip().splitlines()[-1])
        losses = line["amp_losses"]
        at7.append(losses[6])
        last.append(losses[-1])
        print(json.dumps({"run": run, **line}), flush=True)
    print(json.dumps({"runs": runs, "first": losses[0], "step7": at7,
                      "last_step": len(losses), "last": last}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
