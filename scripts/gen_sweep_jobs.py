#!/usr/bin/env python
"""Parameter-sweep job generator — the device counterpart of the
reference's SLURM sweep (/root/reference/scripts/gen-sbatch-scripts.py:74-111,
which emits 210 jobs over seed_len x thres against hg19).

Generates one launch script per (seed_len, thres) parameter point running
`python -m longreadmapper_tpu.cli map` on a GPU host, plus a submit-all
script.  Default grid matches the reference sweep: seed_len in [12, 33),
thres in {100, 200, ..., 1000}.  --slurm emits sbatch headers instead of
plain shell scripts.

Usage:
  gen_sweep_jobs.py REF.fa READS.fq --out-dir jobs/ [--slurm]
      [--seed-lens 12:33] [--thres 100:1001:100] [--batch 1000000]
"""

import argparse
import os
import stat
import sys

SLURM_HEADER = """#SBATCH --job-name={name}
#SBATCH --output={name}.out
#SBATCH --time=20:00:00
#SBATCH --cpus-per-task=36
#SBATCH --mem=200G
"""


def parse_range(s: str):
    parts = [int(x) for x in s.split(":")]
    if len(parts) == 2:
        return range(parts[0], parts[1])
    return range(parts[0], parts[1], parts[2])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ref")
    ap.add_argument("reads")
    ap.add_argument("--out-dir", default="sweep_jobs")
    ap.add_argument("--seed-lens", default="12:33")
    ap.add_argument("--thres", default="100:1001:100")
    ap.add_argument("--batch", type=int, default=1_000_000)
    ap.add_argument("--slurm", action="store_true")
    a = ap.parse_args()

    os.makedirs(a.out_dir, exist_ok=True)
    names = []
    for sl in parse_range(a.seed_lens):
        for th in parse_range(a.thres):
            name = f"map_sl{sl}_th{th}"
            path = os.path.join(a.out_dir, name + ".sh")
            with open(path, "w") as f:
                f.write("#!/bin/bash\n")
                if a.slurm:
                    f.write(SLURM_HEADER.format(name=name))
                f.write(
                    f"python -m longreadmapper_tpu.cli map {a.ref} "
                    f"{a.reads} {a.batch} {sl} {th} "
                    f"> {name}.sam 2> {name}.log\n")
            os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
            names.append(name)

    sub = os.path.join(a.out_dir, "submit_all.sh")
    launcher = "sbatch" if a.slurm else "bash"
    with open(sub, "w") as f:
        f.write("#!/bin/bash\nset -e\n")
        for name in names:
            f.write(f"{launcher} {name}.sh\n")
    os.chmod(sub, os.stat(sub).st_mode | stat.S_IEXEC)
    print(f"wrote {len(names)} job scripts + submit_all.sh to {a.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
