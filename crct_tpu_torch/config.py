"""Configuration layer: model config, dataset config, CLI flags.

The PyTorch port's own copy of ``crct_tpu/config.py`` (the port imports
nothing of the JAX package). It adds ``-device``; flags of paths the port
does not serve yet are accepted and rejected by the entry points that would
act on them. Mirrors the reference's three-layer config system (CRCT/options.py:9-124,
CRCT/backbone/vilbert.py:127-270, CRCT/config/*.json):

  1. argparse flags (same flag surface as the reference),
  2. a dataset-config JSON whose keys override CLI values
     (reference quirk preserved: JSON wins, options.py:93-95),
  3. a model-config JSON parsed into :class:`CRCTModelConfig`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from time import gmtime, strftime
from typing import Any, Dict, List, Optional, Sequence


# 65-entry legal DVQA float table (reference: CRCT/options.py:119-123).
DVQA_FLOATS: List[float] = [
    -9.0, -8.0, -7.0, -6.0, -5.0, -4.0, -3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0,
    4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 11.0, 12.0, 13.0, 14.0, 15.0, 16.0,
    17.0, 18.0, 19.0, 20.0, 21.0, 22.0, 23.0, 24.0, 25.0, 26.0, 27.0, 28.0,
    29.0, 30.0, 31.0, 32.0, 33.0, 34.0, 35.0, 36.0, 37.0, 38.0, 39.0, 40.0,
    41.0, 43.0, 50.0, 60.0, 70.0, 80.0, 90.0, 100.0, 1000.0, 10000.0,
    100000.0, 1000000.0, 10000000.0, 100000000.0, 1000000000.0,
]


@dataclasses.dataclass
class CRCTModelConfig:
    """Model hyper-parameters (reference: CRCT/config/vilbert.json +
    BertConfig at CRCT/backbone/vilbert.py:127-270)."""

    # text stream
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 16
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    plotqa_vocab_types: int = 12
    initializer_range: float = 0.02
    # vision stream
    v_feature_size: int = 1024
    v_target_size: int = 1601
    v_hidden_size: int = 1024
    v_num_hidden_layers: int = 6
    v_num_attention_heads: int = 16
    v_intermediate_size: int = 1024
    v_attention_probs_dropout_prob: float = 0.1
    v_hidden_act: str = "gelu"
    v_hidden_dropout_prob: float = 0.1
    v_initializer_range: float = 0.02
    # bi / co-attention
    bi_hidden_size: int = 1024
    bi_num_attention_heads: int = 32
    bi_intermediate_size: int = 1024
    bi_attention_type: int = 1
    v_biattention_id: Sequence[int] = (0, 1, 2, 3, 4, 5)
    t_biattention_id: Sequence[int] = (6, 7, 8, 9, 10, 11)
    # pooling / fusion ("pooling_method" in the JSON; "fusion_method" in code)
    pooling_method: str = "mul"
    fusion_method: str = "mul"
    # encoder schedule options
    fast_mode: bool = False
    fixed_v_layer: int = 0
    fixed_t_layer: int = 0
    in_batch_pairs: bool = False
    with_coattention: bool = True
    predict_feature: bool = False
    intra_gate: bool = False
    # layer-norm epsilon (reference BertLayerNorm eps, vilbert.py:282)
    layer_norm_eps: float = 1e-12
    # compute dtype: "float32" | "bfloat16" (no reference equivalent)
    dtype: str = "float32"

    def __post_init__(self) -> None:
        self.v_biattention_id = tuple(self.v_biattention_id)
        self.t_biattention_id = tuple(self.t_biattention_id)
        assert len(self.v_biattention_id) == len(self.t_biattention_id)
        if self.v_biattention_id:
            assert max(self.v_biattention_id) < self.v_num_hidden_layers
            assert max(self.t_biattention_id) < self.num_hidden_layers
        assert self.hidden_size % self.num_attention_heads == 0
        assert self.v_hidden_size % self.v_num_attention_heads == 0
        assert self.bi_hidden_size % self.bi_num_attention_heads == 0
        # "pooling_method" (JSON key) is the fusion method in the reference.
        if self.pooling_method and self.fusion_method == "mul":
            self.fusion_method = self.pooling_method

    @classmethod
    def from_json_file(cls, path: str) -> "CRCTModelConfig":
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "CRCTModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})


def read_command_line(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Parse flags + dataset config into a params dict.

    Same flag surface and precedence as the reference
    (CRCT/options.py:9-124): the dataset-config JSON *overrides* CLI values
    and its path fields are absolutized against ``main_folder``.
    """
    parser = argparse.ArgumentParser(
        description="CRCT (PyTorch/CUDA port): chart question answering")
    parser.add_argument('-command', type=str, default=" ".join(sys.argv))
    parser.add_argument('-start_checkpoint', default='')
    parser.add_argument('-model_config', default='')
    parser.add_argument('-num_workers', default=16, type=int)
    parser.add_argument('-batch_size', default=80, type=int)
    parser.add_argument('-num_epochs', default=20, type=int)
    parser.add_argument('-batch_multiply', default=1, type=int)
    parser.add_argument('-lr', default=2e-5, type=float)
    parser.add_argument('-image_lr', default=2e-5, type=float)
    parser.add_argument('-min_lr', default=1.3e-5, type=float)
    parser.add_argument('-continue', action='store_true', dest='continue_')
    parser.add_argument('-max_seq_len', default=256, type=int)
    parser.add_argument('-nsp_loss_coeff', default=1, type=float)
    parser.add_argument('-reg_loss_coeff', default=1, type=float)
    parser.add_argument('-L1', action='store_true')
    parser.add_argument('-mask_prob', default=0, type=float)
    parser.add_argument('-mask_prob_img', default=0, type=float)
    parser.add_argument('-mask_img_loc', type=float, default=0)
    parser.add_argument('-save_path', default='')
    parser.add_argument('-save_name', default='')
    # None = train/eval_loop.EVAL_AUTO_ROWS_PER_CARD rows per dispatch; pass
    # an explicit value (the reference default was 10, CRCT/options.py) for
    # protocol-parity runs
    parser.add_argument('-eval_batch_size', default=None, type=int)
    # DDP-era flags kept for CLI compatibility; data parallelism is not
    # ported yet
    parser.add_argument('-ddp', action='store_true',
                        help='not ported: data parallelism')
    parser.add_argument('-rank', type=int, default=0)
    parser.add_argument('-dist_url', default='')
    parser.add_argument('-world_size', type=int, default=1)
    parser.add_argument('-num_proc', type=int, default=1)
    parser.add_argument('-rank_from', type=int, default=0)
    parser.add_argument('-gpu_from', type=int, default=0)
    parser.add_argument('-cuda_num', default=-1, type=int,
                        help='with -device cuda: the card index (-1 = the '
                             'current card)')
    parser.add_argument('-device', type=str, default='cuda',
                        choices=['cuda', 'cpu'],
                        help='where the model runs; the CPU only when asked')
    parser.add_argument('-seed', type=int, default=0)
    parser.add_argument('-figure_feat_path', default="")
    parser.add_argument('-qa_parent_dir', default="")
    parser.add_argument('-qa_file', required=True)
    parser.add_argument('-fixed_vocab', action="store_true")
    parser.add_argument('-no_eval', action="store_true")
    parser.add_argument('-details', type=str, default="None")
    parser.add_argument('-pretrain', action="store_true")
    parser.add_argument('-wd', default=0.01, type=float)
    parser.add_argument('-tol_margin', default=0.01, type=float)
    parser.add_argument('-warmup', default=3000, type=int)
    parser.add_argument('-log_file', type=str, default="None")
    parser.add_argument('-hist_name', type=str, default="")
    parser.add_argument('-dataset', type=str, default="plotqa")
    parser.add_argument('-categories', type=int)
    parser.add_argument('-CE_REG', action="store_true")
    parser.add_argument('-BOT_MODE', action="store_true")
    parser.add_argument('-hbar_bbox_t', type=lambda x: str(x).lower() == 'true',
                        default=False)
    parser.add_argument('-binary_answers', type=lambda x: str(x).lower() == 'true',
                        default=False)
    parser.add_argument('-eval_set', type=str, default='val')
    parser.add_argument('-eval_type', type=str,
                        choices=['vocab_table', 'examples'], default='vocab_table')
    parser.add_argument('-tensorboard', default="")
    parser.add_argument('-checkpoints_dir', type=str, default='')
    parser.add_argument('-dataset_config', type=str, default='')
    parser.add_argument('-vocab_file', type=str, default='',
                        help='WordPiece vocab.txt (bert-base-uncased layout)')
    parser.add_argument('-bf16', action='store_true',
                        help='bfloat16 activations')
    # flags of the JAX package that the port accepts but does not serve yet
    parser.add_argument('-pallas', action='store_true',
                        help='not ported: the CUDA attention kernel always '
                             'runs on the card')
    parser.add_argument('-mesh_shape', type=str, default='',
                        help='not ported: data parallelism')
    parser.add_argument('-profile', action='store_true',
                        help='cli.train: torch.profiler trace of steps 10-15 '
                             'under <save_path>/profile')
    parser.add_argument('-fs_steps', type=int, default=2000,
                        help='fast-scorer head training steps')
    parser.add_argument('-fs_lr', type=float, default=1e-3,
                        help='fast-scorer head learning rate')
    parser.add_argument('-fast_scorer', action='store_true',
                        help='opt-in light candidate scorer: one backbone '
                             'pass per question at eval instead of the '
                             'x120 candidate fan-out (train the head first '
                             'with cli.train -fast_scorer)')
    parser.add_argument('-fast_scorer_topk', type=int, default=0,
                        help='with -fast_scorer: the fast head only '
                             'SHORTLISTS this many candidates and the full '
                             'model rescores them — exact reference '
                             'numerics whenever the true answer is in the '
                             'shortlist, ~(120/K)x cheaper than the full '
                             'fan-out (0 = fast head scores alone)')
    parser.add_argument('-predictions_out', type=str, default='',
                        help='cli.evaluate: also write one JSONL prediction '
                             'record per question (answer, confidence, '
                             'reg_output, gt) — batch answer serving at '
                             'eval-loop throughput; rank-suffixed when '
                             'multi-process')
    parser.add_argument('-port', type=int, default=8373,
                        help='cli.serve: HTTP port (0 picks a free port)')
    parser.add_argument('-serve_max_batch', type=int, default=32,
                        help='cli.serve: max questions coalesced into one '
                             'model dispatch by the dynamic batcher')
    parser.add_argument('-serve_max_delay_ms', type=float, default=5.0,
                        help='cli.serve: how long the first waiting request '
                             'holds the batching window open')
    parser.add_argument('-serve_detector_weights', type=str, default='',
                        help='cli.serve: detector checkpoint; enables '
                             'POST /v1/figures chart-PNG ingestion '
                             '(detector + extraction run in-process). '
                             '"none" = random init (smoke)')
    parser.add_argument('-serve_detector_canvas', type=str, default='832,1344',
                        help='cli.serve: compiled detector canvas H,W '
                             '(multiples of 32)')
    parser.add_argument('-serve_short_edge', type=int, default=800,
                        help='cli.serve: ingest-time ResizeShortestEdge '
                             'target (0 = only downscale to fit)')
    parser.add_argument('-serve_max_figures', type=int, default=512,
                        help='cli.serve: max ingested figure records held '
                             'in memory (FIFO eviction beyond this)')
    parser.add_argument('-serve_no_dataset', action='store_true',
                        help='cli.serve: serve WITHOUT feature shards / QA '
                             'files — every figure arrives over '
                             'POST /v1/figures (requires '
                             '-serve_detector_weights)')
    parser.add_argument('-max_checkpoints', type=int, default=0,
                        help='keep only the newest K epoch checkpoints '
                             '(0 = keep all, the reference behavior; at '
                             'flagship scale each is ~1.3 GB)')
    parser.add_argument('-no_nan_guard', action='store_true',
                        help='disable the train-loop failure detector '
                             '(non-finite loss halts training with a '
                             'diagnostic checkpoint; the reference trains '
                             'on through NaNs silently)')
    parser.add_argument('-rng_impl', type=str, default='rbg',
                        choices=['rbg', 'threefry2x32'],
                        help='not used by the port')
    parser.add_argument('-opt_bf16_m', action='store_true',
                        help='bfloat16 AdamW first moments: ~0.4 GB less '
                             'optimizer state and ~14%% less update-phase '
                             'HBM traffic at flagship scale (second '
                             'moments and params stay f32; changes '
                             'numerics slightly vs the reference)')

    parsed = vars(parser.parse_args(args=argv))
    parsed['continue'] = parsed.pop('continue_')

    dataset_config: Dict[str, Any] = {}
    if parsed['dataset_config']:
        with open(parsed['dataset_config'], "r") as f:
            dataset_config = json.load(f)
        # absolutize paths against main_folder (reference options.py:90-91)
        for sub_path in ['figure_feat_path', 'model_config', 'save_path',
                         'tensorboard', 'checkpoints_dir', 'qa_parent_dir']:
            if sub_path in dataset_config:
                dataset_config[sub_path] = os.path.join(
                    dataset_config.get('main_folder', ''), dataset_config[sub_path])
        # JSON overrides CLI (reference options.py:93-95)
        for key in dataset_config:
            parsed[key] = dataset_config[key]

    if parsed['save_name']:
        parsed['save_path'] = os.path.join(parsed['save_path'], parsed['save_name'])
    else:
        import random
        stamp = strftime('%d-%b-%y-%X-%a', gmtime())
        parsed['save_path'] = os.path.join(parsed['save_path'], stamp)
        parsed['save_path'] += '_{:0>6d}'.format(random.randint(0, int(10e6)))

    parsed['dataset_config'] = dataset_config

    if parsed['start_checkpoint'] and not os.path.exists(parsed['start_checkpoint']):
        parsed['start_checkpoint'] = parsed['checkpoints_dir'] + parsed['start_checkpoint']
        assert os.path.exists(parsed['start_checkpoint']), (
            f"start_checkpoint file not found: {parsed['start_checkpoint']}")

    if parsed['ddp']:
        # preserved reference quirk (options.py:114-117): the run seed is
        # the random suffix of the auto-generated rendezvous url
        if not parsed['dist_url']:
            import numpy as _np
            parsed['dist_url'] = (f"file://{parsed.get('main_folder', '')}"
                                  f"DDP_TEMP_FILE_{_np.random.randint(10000)}")
        tail = parsed['dist_url'].split("_")[-1]
        if tail.isdigit():
            parsed['seed'] = int(tail)

    parsed['dvqa_floats'] = list(DVQA_FLOATS)
    return parsed


def default_params(**overrides: Any) -> Dict[str, Any]:
    """A params dict with REFERENCE defaults, for library/test use without
    CLI. Note eval_batch_size=10 is the reference's protocol value
    (CRCT/options.py) — the CLI default is None (240 rows per card, see
    train/eval_loop.resolve_eval_chunk); pass eval_batch_size=None
    explicitly to opt a library caller into it."""
    params: Dict[str, Any] = dict(
        start_checkpoint='', model_config='', num_workers=0, batch_size=8,
        num_epochs=1, batch_multiply=1, lr=2e-5, image_lr=2e-5, min_lr=1.3e-5,
        max_seq_len=124, nsp_loss_coeff=1.0, reg_loss_coeff=1.0, L1=False,
        mask_prob=0.0, mask_prob_img=0.0, mask_img_loc=0.0, save_path='',
        save_name='', eval_batch_size=10, ddp=False, rank=0, world_size=1,
        num_proc=1, rank_from=0, gpu_from=0, cuda_num=-1, seed=0,
        figure_feat_path='', qa_parent_dir='', qa_file='qa_pairs.npy',
        fixed_vocab=False, no_eval=False, details='None', pretrain=False,
        wd=0.01, tol_margin=0.01, warmup=3000, log_file=None, hist_name='',
        dataset='plotqa', categories=228, CE_REG=False, BOT_MODE=False,
        hbar_bbox_t=False, binary_answers=False, eval_set='val',
        eval_type='vocab_table', tensorboard='', checkpoints_dir='',
        dataset_config={}, max_vis_features=44, splits=['train', 'val', 'test'],
        dvqa_floats=list(DVQA_FLOATS), vocab_file='', bf16=False, pallas=False,
        mesh_shape='', dist_url='', profile=False, rng_impl='rbg',
        opt_bf16_m=False, no_nan_guard=False, max_checkpoints=0,
        fast_scorer=False, fast_scorer_topk=0, fs_steps=2000, fs_lr=1e-3,
        predictions_out='',
        port=8373, serve_max_batch=32, serve_max_delay_ms=5.0,
        serve_detector_weights='', serve_detector_canvas='832,1344',
        serve_short_edge=800, serve_no_dataset=False, serve_max_figures=512,
        device='cuda',
    )
    params['continue'] = False
    params.update(overrides)
    return params
