"""A run of a cell on the CPU at tiny widths, for the benchmark's tests."""

from __future__ import annotations

import argparse
import copy
import json
import os

import torch

from perfbench import run

TINY_MODEL = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
                  intermediate_size=64, v_hidden_size=32,
                  v_num_hidden_layers=2, v_num_attention_heads=2,
                  v_intermediate_size=32, bi_hidden_size=32,
                  bi_num_attention_heads=4, v_biattention_id=[0, 1],
                  t_biattention_id=[2, 3], v_feature_size=64)


def bench():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def context(cell_name: str, seed: int = 7, seconds: float = 0.5,
            trace: int = 0, **mix_overrides):
    b = bench()
    cell = next(c for c in b["workloads"] if c["name"] == cell_name)
    cfg = run.load_json(run.HERE, "configs", f"{cell['config']}.json")
    cfg = copy.deepcopy(cfg)
    cfg["model"].update(TINY_MODEL)
    mix = dict(run.load_json(run.HERE, "mixes", f"{cell['traffic']}.json"))
    small = {"batch": 4, "pool_batches": 4, "warmup_steps": 1,
             "trace_steps": 2, "questions": 12, "question_batch": 4,
             "candidates": {"fixed": 3, "uniform": [[0, 6]]},
             "check_questions": 6, "calibrate_batches": 2}
    mix.update({k: v for k, v in small.items() if k in mix})
    mix.update(mix_overrides)
    args = argparse.Namespace(seed=seed, seconds=seconds, trace=trace)
    return run.Context(b, cell, args, torch.device("cpu"), cfg=cfg, mix=mix)
