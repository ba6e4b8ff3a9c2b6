"""The control of ``correct``'s comparison, read at a cell's own size, on
the card:

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

For each seed it makes the cell's inputs as a run does (the forest and
every row the window's answers cover), scores them with the reference, and
with the reference one precision below the configuration's (``control``
in the configuration file: ``bf16`` rows and thresholds for a standard
forest, ``tf32`` products for an extended one), and prints the numbers of
:mod:`portbench.check` of the control against the configuration's limits.
The benchmark's own runs never run it.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def rows_of(cell, seed, device):
    from portbench import inputs

    return inputs.scored_rows(cell.config, int(cell.mix["rows"]), seed=seed, device=device, place="device")


def main(argv=None) -> int:
    import torch

    from portbench import check, inputs, spec
    from portbench.loops import Answer
    from portbench.reference import score as ref_score

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    cell = spec.load_cell(args.workload)
    config = cell.config
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        forest = inputs.forest_tensors(inputs.grow_forest(config, seed=seed, device=device), device)
        X = rows_of(cell, seed, device)
        truth = ref_score.score(forest, X, max_samples=config["maxSamples"])
        control = ref_score.score(forest, X, max_samples=config["maxSamples"], precision=config["control"]).scores
        numbers = check.compare([Answer(0, X.shape[0], control.float())], 1, truth)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": config["control"], "rows": X.shape[0],
                          "numbers": numbers, "limits": config["limits"],
                          "fails": not check.judge(numbers, config["limits"]),
                          "seconds": time.perf_counter() - t0}), flush=True)
        del forest, X, truth, control
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
