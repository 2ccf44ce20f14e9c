"""The readings the limits of a cell's comparison are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,...
        [--control-seeds 1,2,3]

For each seed it builds the cell as a run does, drives the timed path until
the evaluations or the Heun step that a run keeps for its check are done,
and compares them with the reference, as a run's check does: the program's
readings.  On the control seeds it also reads the control at the same
state, the step a later change would be tempted to take: where the
configuration serves bf16, the program with its own int8 path switched on
(``precision="int8"``, the port's default knobs); where it serves int8,
the reference with its (5,3) stage convs of the int8 stacks in 4 bits, in
the program's place; for training, the trainer's own int8 path
(``BABE_PRECISION=int8``, quantization-aware training).  One JSON line per seed and reading, then the largest
program reading and the smallest control reading of each number.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from perfbench import harness, traffic  # noqa: E402
from perfbench.loops import WindowClosed  # noqa: E402
from perfbench.faults import FAULTS, Patch  # noqa: E402


def make_run(workload: str, seed: int, device) -> harness.Run:
    man = harness.manifest()
    w = harness.cell(man, workload)
    config = harness.load_json(harness.HERE, "configs", f"{w['config']}.json")
    mix = traffic.load(w["traffic"])
    limits = harness.load_json(harness.HERE, "limits", f"{workload}.json")
    return harness.Run(workload=workload, seed=seed, seconds=0.0,
                       trace=False, config=config, mix=mix, limits=limits,
                       device=device, t_start=time.perf_counter())


def restore(run, control: bool) -> dict:
    from babe_tpu_torch.ops.stft import apply_stft

    from perfbench.loops import restore as R

    cell = R.Cell(run)
    cell.wanted = R.pick(run, cell.E)
    cell.clock.stop_after = max(i for _, i in cell.wanted) + 1
    try:
        cell.serve(0)
    except WindowClosed:
        pass
    refs = R.reference(run, cell.samples, cell.weights)
    out = {"program": R.compare(run, cell.samples, cell.weights, refs=refs),
           # the fit left where it started: its objective's gap
           "fit_unchanged": max(abs(r["J"][2] - r["J"][0]) / r["J"][0]
                                for r in refs) if refs else None}
    if not control:
        return out
    if run.config["precision"] == "int8":
        ctrl = []
        for s in cell.samples:
            r = reference_stage(run, s, cell.weights, quant_bits=4)
            ctrl.append(dict(s, score=r[0], params_out=r[1], x_den=r[2]))
    else:
        cell.model.net.set_precision("int8")
        stage = type(cell.sampler)._stage
        nfft = int(run.config["tester"]["blind_bwe"]["NFFT"])
        ctrl = []
        for s in cell.samples:
            score, params, x_den = stage(cell.sampler, s["x_hat"], s["t"],
                                         s["params"], s["y"],
                                         apply_stft(s["y"], nfft), None)
            ctrl.append(dict(s, score=score, params_out=params, x_den=x_den))
    out["control"] = R.compare(run, cell.samples, cell.weights,
                               outputs=ctrl)
    return out


def reference_stage(run, s, weights, quant_bits):
    """The reference's whole guided evaluation from a kept state, in
    ``quant_bits`` where the configuration runs int8."""
    from perfbench.loops import net_config, reference_precision
    from perfbench.loops.restore import blind_config
    from perfbench.reference.diffusion import EDMConfig, guided_stage

    reference_precision()
    e = EDMConfig(float(run.config["tester"]["diff_params"]["sigma_data"]))
    return guided_stage(weights, net_config(run, quant_bits), e,
                        blind_config(run), s["x_hat"], s["t"], s["params"],
                        s["y"])


def generate(run, control: bool) -> dict:
    from perfbench.loops import generate as G

    cell = G.Cell(run)
    cell.want = G.pick(run, cell)
    last = max(i for _, i in cell.want)
    cell.clock.stop_after = 2 * last + 3 if last < cell.E // 2 else None
    try:
        cell.serve(0)
    except WindowClosed:
        pass
    kept = list(cell.kept.values())
    out = {"program": G.compare(run, kept, cell.weights)}
    if control:
        cell.model.net.set_precision("int8")
        out["control"] = G.compare(run, [G.control_step(cell, k)
                                         for k in kept], cell.weights)
    return out


def train(run, control: bool) -> dict:
    import shutil
    import tempfile

    from perfbench.loops import free
    from perfbench.loops import train as T

    def steps():
        folder = tempfile.mkdtemp(prefix="perfbench-calibrate-")
        try:
            cell = T.Cell(run, folder)
            cell.first_steps()
            kept, weights = cell.checked, cell.weights
            cell.data.close()
            del cell
            free()
            return T.compare(run, kept, weights)
        finally:
            shutil.rmtree(folder, ignore_errors=True)

    out = {"program": steps()}
    if control:
        # the trainer's own int8 path (quantization-aware training)
        os.environ["BABE_PRECISION"] = "int8"
        try:
            out["control"] = steps()
        finally:
            del os.environ["BABE_PRECISION"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", choices=sorted(FAULTS),
                   help="plant this fault in the program (its readings are "
                        "then the fault's)")
    a = p.parse_args(argv)
    harness.clear_program_environment()
    harness.cache_environment()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in a.seeds.split(",") if s]
    ctrl = {int(s) for s in a.control_seeds.split(",") if s}
    worst, least = {}, {}
    for seed in sorted(set(seeds) | ctrl):
        run = make_run(a.workload, seed, torch.device("cuda", 0))
        kind = run.mix["kind"]
        t = time.perf_counter()
        patch = Patch()
        if a.fault:
            FAULTS[a.fault](patch, kind)
        try:
            out = {"restore": restore, "generate": generate,
                   "train": train}[kind](run, seed in ctrl)
        finally:
            patch.undo()
        out = {"seed": seed, "seconds": time.perf_counter() - t, **out}
        print(json.dumps(out), flush=True)
        if seed in seeds:
            for k, v in out["program"].items():
                worst[k] = max(worst.get(k, 0.0), v)
        for k, v in out.get("control", {}).items():
            least[k] = min(least.get(k, float("inf")), v)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": a.workload, "program_max": worst,
                      "control_min": least,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
