"""A cell of the benchmark at a tiny size on the CPU: the tests drive the
harness's loops with it, past the look for a card."""

from __future__ import annotations

import copy
import time

import torch

from perfbench import harness, traffic

SEED = 2**31 + 7  # a seed past 32 signed bits


def tiny_config(config: dict) -> dict:
    c = copy.deepcopy(config)
    c["network"].update({"Ns": [8, 8, 16], "num_dils": [1, 1, 2],
                         "emb_dim": 32, "attention_layers": [0, 0, 0, 0]})
    c["network"]["cqt"].update({"num_octs": 3, "bins_per_oct": 8})
    c["exp"]["audio_len"] = 4096
    c["tester"]["T"] = 3
    c["tester"]["blind_bwe"]["NFFT"] = 512
    c["tester"]["blind_bwe"]["optimization"]["max_iter"] = 4
    c["tester"]["unconditional"].update({"audio_len": 4096,
                                         "num_samples": 2})
    if c["precision"] == "int8":
        c["int8"].update({"minc": 8, "fused": 8})
    return c


def tiny_run(workload: str, seconds: float = 1.0, trace: bool = False,
             seed: int = SEED) -> harness.Run:
    man = harness.manifest()
    w = harness.cell(man, workload)
    config = tiny_config(harness.load_json(harness.HERE, "configs",
                                           f"{w['config']}.json"))
    mix = traffic.load(w["traffic"])
    if mix["kind"] == "restore":
        mix["segments"] = 2
    if mix["kind"] == "train":
        mix["batch"] = 2
        mix["data"].update({"files": 2, "seconds": 1.0})
    mix["trace"] = {"start": 1, "count": 1}
    limits = harness.load_json(harness.HERE, "limits", f"{workload}.json")
    return harness.Run(workload=workload, seed=seed, seconds=seconds,
                       trace=trace, config=config, mix=mix, limits=limits,
                       device=torch.device("cpu"),
                       t_start=time.perf_counter())
