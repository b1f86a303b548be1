"""The control of a cell's comparison: the plain reference put in the
program's place one precision below the configuration's, judged as a run
is judged. It has to come out not correct.

    python3 benchmark/control.py --workload c2048-gs-device --seeds 11 12 13

For each seed, the first ``check.instances_per_run`` instances of the
cell's pool are solved twice: by the program as the window solves them
(whole units), and by the reference in float32 with TF32 matmuls on (the
configuration states float32 with TF32 off). The control's answer to an
instance carries the program's flag for it, whether its merge was
complete, so that its degeneracy is compared where the program's would
be. Both go through the cell's comparison: the program's readings are
those of a sound run beside the control's. One JSON line per seed and
side; runs on the card and is not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import cell as _cell  # noqa: E402
from benchmark.harness import instances  # noqa: E402
from benchmark.harness.answers import Answer  # noqa: E402


def program_answers(c, pool, count, torch, device):
    """The program's answers to the pool's first ``count`` instances."""
    import tnax_torch as tt
    dtype = getattr(torch, c.config["solver"]["dtype"])
    batch = c.traffic["batch"]
    items = list(enumerate(pool))
    got = []
    for u in range(-(-count // batch)):
        got += c.driver().run(tt, c.config, c.traffic["params"],
                              items[u * batch:(u + 1) * batch], device,
                              dtype)
    return [a for a in got if a.k < count]


def control_answers(c, pool, program, torch, device):
    """The reference's answers in float32 with TF32 on, one for each of
    the program's answers, with its ``exact`` flag."""
    check = c.check()
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        out = []
        for a in program:
            _, r = check.reference_search(c.config, pool[a.k], torch, device,
                                          dtype=torch.float32)
            out.append(Answer(a.k, r.energy, r.bits, r.degeneracy, r.log2p,
                              exact=a.exact))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def readings(c, seed, torch, device, log=print):
    """[(side, seconds, numbers)] for the program and the control on
    ``seed``'s first instances; the reference runs once per instance."""
    count = c.config["check"]["instances_per_run"]
    units = -(-count // c.traffic["batch"])
    pool = instances.make_pool(c.config["instance"]["cells"], seed,
                               units * c.traffic["batch"])
    ks, refs, out = list(range(count)), {}, []
    t0 = time.perf_counter()
    program = program_answers(c, pool, count, torch, device)
    t1 = time.perf_counter()
    control = control_answers(c, pool, program, torch, device)
    t2 = time.perf_counter()
    for side, answers, seconds in (("program", program, t1 - t0),
                                   ("control", control, t2 - t1)):
        out.append((side, seconds, c.check().compare(
            c.config, pool, ks, answers, seed, torch, device, log=log,
            refs=refs)))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    c = _cell.load_cell(args.workload)
    for seed in args.seeds:
        for side, seconds, numbers in readings(
                c, seed, torch, torch.device("cuda:0"),
                log=lambda m: print(m, file=sys.stderr)):
            print(json.dumps({"workload": c.name, "side": side,
                              "seed": seed, "seconds": seconds,
                              "correct": c.check().passed(numbers),
                              "numbers": {n: v for n, v, _ in numbers}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
