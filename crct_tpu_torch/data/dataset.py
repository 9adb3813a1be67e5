"""Sharded fig-feature + QA-pair dataset with fixed-shape examples.

The port's copy of ``ChartQADataset`` and ``collate`` from
``crct_tpu/data/dataset.py`` (reference CRCT/fig_dataloader.py:13-156):
`.npy` feature shards are loaded lazily and keyed by
``image_id // division``; QA files load from `.npy` or `.json`; the train
split is length-doubled so the second half yields random-negative examples.
The multi-worker loader is not ported yet.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from crct_tpu_torch.data.example_builder import ExampleBuilder
from crct_tpu_torch.data.tokenizer import WordPieceTokenizer, load_tokenizer

_HOST_KEYS = ['qid', 'qa_type']


class ChartQADataset:
    """Loads QA pairs + feature shards and yields fixed-shape examples."""

    def __init__(self, params: Dict[str, Any],
                 splits_to_load: Optional[Sequence[str]] = None,
                 init_split: str = 'train',
                 tokenizer: Optional[WordPieceTokenizer] = None):
        self.params = params
        self.tokenizer = tokenizer or load_tokenizer(params.get('vocab_file', ''))
        self.builder = ExampleBuilder(params, self.tokenizer)
        self.fig_feats: Dict[str, Dict[int, Any]] = {}
        self.qa: Dict[str, Any] = {}
        self._split = init_split
        self.get_all_answers = False
        self.epoch = 0
        self._lock = threading.Lock()
        if splits_to_load is None:
            splits_to_load = ['train', params['eval_set']]
        if isinstance(splits_to_load, str):
            splits_to_load = [splits_to_load]
        self.load_files(splits_to_load)

    @property
    def split(self) -> str:
        return self._split

    @split.setter
    def split(self, split: str) -> None:
        if split not in ('train', 'val', 'test', 'test1', 'test2'):
            raise ValueError(f"unknown split {split!r}")
        self._split = split

    def split_path(self, split: str) -> str:
        """Map logical split -> on-disk directory (fig_dataloader.py:119-129)."""
        order = ['train', 'val', 'test', 'test1', 'test2']
        return self.params['splits'][order.index(split)]

    def load_files(self, splits: Sequence[str]) -> None:
        for split in splits:
            pattern = os.path.join(self.params['figure_feat_path'],
                                   self.split_path(split), "*.npy")
            files = sorted(glob.glob(pattern),
                           key=lambda x: float(re.findall(r"(\d+)", x)[-1]))
            if not files:
                raise FileNotFoundError(f"no feature shards match {pattern}")
            self.fig_feats[split] = {i: f for i, f in enumerate(files)}
            qa_path = os.path.join(self.params['qa_parent_dir'],
                                   self.split_path(split), self.params['qa_file'])
            if self.params['qa_file'].endswith('.npy'):
                self.qa[split] = np.load(qa_path, allow_pickle=True)
            else:
                with open(qa_path) as f:
                    loaded = json.load(f)
                self.qa[split] = loaded.get('qa_pairs', loaded) \
                    if isinstance(loaded, dict) else loaded

    def orig_len(self) -> int:
        return len(self.qa[self._split])

    def __len__(self) -> int:
        # train length doubles: second half yields random negatives
        # (fig_dataloader.py:112-114)
        mult = 2 if (self._split == 'train'
                     and not self.params['binary_answers']) else 1
        return self.orig_len() * mult

    def get_qa(self, idx: int) -> Dict[str, Any]:
        orig = self.orig_len()
        if self._split == 'train' and idx >= orig:
            return self.qa[self._split][idx - orig]
        return self.qa[self._split][idx]

    def get_division(self) -> int:
        return self.params['dataset_config']['dataset_files_divisions'][self._split]

    def get_fig_feat(self, image_id: int) -> Dict[str, Any]:
        image_index = image_id if self.params['dataset'] != 'dvqa' else image_id - 1
        file_id = image_index // self.get_division()
        with self._lock:
            entry = self.fig_feats[self._split][file_id]
            if isinstance(entry, str):
                entry = np.load(entry, allow_pickle=True)
                self.fig_feats[self._split][file_id] = entry
        fig_feat = entry[image_index % self.get_division()]
        if fig_feat['image_id'] != image_id:
            raise KeyError(f"figure {image_id}: shard holds "
                           f"{fig_feat['image_id']} at its slot")
        return fig_feat

    def get_possible_answers(self, image_id: int,
                             fig_feat: Optional[Dict] = None) -> List[str]:
        if fig_feat is None:
            fig_feat = self.get_fig_feat(image_id)
        return self.builder.get_possible_answers(fig_feat)

    def __getitem__(self, qa_ind: int) -> Dict[str, Any]:
        qa_pair = self.get_qa(qa_ind)
        fig_feat = self.get_fig_feat(qa_pair['image_index'])
        if self.params['dataset'] == 'figure_qa' and 'test' in self._split:
            raise NotImplementedError("figure_qa test-split colour mapping is "
                                      "not ported yet")
        negative = self._split == 'train' and qa_ind >= self.orig_len()
        # the epoch is mixed in so negatives/masking resample every epoch
        seed = ((self.params.get('seed', 0) * 1_000_003 + self.epoch * 988_663
                 + qa_ind) & 0x7FFFFFFF)
        return self.builder.build(fig_feat, qa_pair, split=self._split,
                                  negative=negative,
                                  get_all_answers=self.get_all_answers,
                                  qa_ind=qa_ind,
                                  rng=np.random.default_rng(seed))


def collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack per-example dicts into a batch of arrays (host-side)."""
    batch: Dict[str, Any] = {}
    for key in items[0]:
        if key in _HOST_KEYS or isinstance(items[0][key], str):
            batch[key] = [it[key] for it in items]
        else:
            batch[key] = np.stack([np.asarray(it[key]) for it in items])
    return batch
