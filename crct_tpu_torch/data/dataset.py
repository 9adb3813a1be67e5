"""Sharded fig-feature + QA-pair dataset with fixed-shape examples.

The port's copy of ``ChartQADataset``, ``collate`` and ``DataLoader`` from
``crct_tpu/data/dataset.py`` (reference CRCT/fig_dataloader.py:13-156):
`.npy` feature shards are loaded lazily and keyed by
``image_id // division``; QA files load from `.npy` or `.json`; the train
split is length-doubled so the second half yields random-negative examples.
``DataLoader`` shuffles per epoch from a seed, drops the ragged tail and
builds batches in one producer thread or, with more than one worker, in
spawned worker processes; the batch order equals the JAX loader's for the
same seed and epoch.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence

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

    def get_raw(self, idx: int) -> Dict[str, Any]:
        return self.get_qa(int(idx))

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

    def get_ans_type(self, qa_ind: int) -> int:
        return self.builder.get_ans_type(self.get_raw(qa_ind)['answer'])

    def __getitem__(self, qa_ind: int) -> Dict[str, Any]:
        qa_pair = self.get_qa(qa_ind)
        fig_feat = self.get_fig_feat(qa_pair['image_index'])
        if self.params['dataset'] == 'figure_qa' and 'test' in self._split:
            # rewrite unseen color names via nearest detections (reference
            # fig_dataloader.py:435-439) on copies of the QA pair and of
            # the text features
            from crct_tpu_torch.data.figureqa import ColorMapping
            qa_pair = dict(qa_pair)
            fig_feat = self.builder._cow_fig_feat(fig_feat)
            ColorMapping().feature_replace(self.params, qa_pair, fig_feat)
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


# ---------------------------------------------------------------------------
# process-worker machinery (spawned: never inherits the parent's CUDA state)
# ---------------------------------------------------------------------------

_WORKER_DS: Optional[ChartQADataset] = None
_WORKER_ERR: Optional[BaseException] = None


def _worker_init(params: Dict[str, Any], splits: List[str]) -> None:
    global _WORKER_DS, _WORKER_ERR
    try:
        _WORKER_DS = ChartQADataset(params, splits, init_split=splits[0])
    except BaseException as e:   # surface via the first job, don't respawn-loop
        _WORKER_ERR = e


def _worker_build(job) -> Dict[str, Any]:
    if _WORKER_ERR is not None:
        raise RuntimeError(f"dataset worker failed to initialize: "
                           f"{_WORKER_ERR!r}")
    indices, split, get_all, epoch = job
    assert _WORKER_DS is not None
    _WORKER_DS.split = split
    _WORKER_DS.get_all_answers = get_all
    _WORKER_DS.epoch = epoch
    return collate([_WORKER_DS[int(i)] for i in indices])


def _picklable(params: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in params.items()
            if isinstance(v, (str, int, float, bool, list, tuple, dict,
                              type(None), np.ndarray))}


class DataLoader:
    """Loader with seeded per-epoch shuffling and drop_last (the port of
    ``crct_tpu/data/dataset.py::DataLoader``). ``num_shards`` /
    ``shard_index`` replace the reference's ``DistributedSampler``
    (train.py:55): each rank takes its interleaved slice of the epoch's
    index list, padded to a multiple of the shards by repeating its head.

    With ``num_workers > 1`` batches are built in that many spawned worker
    processes (the reference's torch DataLoader worker model,
    train.py:54-73), else in one background producer thread that overlaps
    building with the consumer's device time. Batches are byte-identical
    either way: every example draws from its own index-seeded RNG. A worker
    pool that fails raises; there is no second path.
    """

    def __init__(self, dataset: ChartQADataset, batch_size: int, *,
                 shuffle: bool = True, seed: int = 0, num_workers: int = 8,
                 drop_last: bool = True, num_shards: int = 1,
                 shard_index: int = 0,
                 indices: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0
        self.indices = indices
        self._pool = None
        self._idx_cache: Optional[tuple] = None   # (epoch, indices array)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        # per-example RNG mixes the epoch in so negatives/masking resample
        # every epoch (the reference's unseeded np.random draws fresh)
        self.dataset.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        # cached per epoch: len(loader) is read several times per log line
        if self._idx_cache is not None and self._idx_cache[0] == self.epoch:
            return self._idx_cache[1]
        idx = (np.asarray(self.indices, np.int64) if self.indices is not None
               else np.arange(len(self.dataset), dtype=np.int64))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(idx)
        # pad to a multiple of the shards (DistributedSampler semantics)
        total = -(-len(idx) // self.num_shards) * self.num_shards
        if total > len(idx) and len(idx) > 0:
            idx = np.concatenate([idx, idx[:total - len(idx)]])
        idx = idx[self.shard_index::self.num_shards]
        self._idx_cache = (self.epoch, idx)
        return idx

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    # -- process pool -----------------------------------------------------
    def _ensure_pool(self):
        if self._pool is None:
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
            splits = list(self.dataset.fig_feats.keys())
            self._pool = ctx.Pool(
                self.num_workers, initializer=_worker_init,
                initargs=(_picklable(self.dataset.params), splits))
        return self._pool

    def close(self) -> None:
        """Stop the worker processes, if any."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _batches(self) -> List[np.ndarray]:
        idx = self._epoch_indices()
        return [idx[b * self.batch_size:(b + 1) * self.batch_size]
                for b in range(len(self))]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        chunks = self._batches()
        if self.num_workers > 1:
            yield from self._iter_process(chunks)
        else:
            yield from self._iter_thread(chunks)

    def _iter_process(self, chunks) -> Iterator[Dict[str, Any]]:
        pool = self._ensure_pool()
        split = self.dataset.split
        get_all = self.dataset.get_all_answers
        window = 2 * self.num_workers
        pending = []
        for c in chunks:
            pending.append(pool.apply_async(
                _worker_build, ((c, split, get_all, self.epoch),)))
            while len(pending) > window:
                yield pending.pop(0).get(timeout=600)
        for fut in pending:
            yield fut.get(timeout=600)

    def _iter_thread(self, chunks) -> Iterator[Dict[str, Any]]:
        # one producer thread: example building holds the GIL, so more
        # threads only add contention; one still overlaps the device time
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = []
            for c in chunks:
                pending.append(pool.submit(
                    lambda cc: collate([self.dataset[int(i)] for i in cc]), c))
                while len(pending) > 4:
                    yield pending.pop(0).result()
            for fut in pending:
                yield fut.result()
