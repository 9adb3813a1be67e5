"""Rank-gated run logging (reference CRCT/utils.py:32-47).

The port's copy of ``crct_tpu/utils/logging.py``. Under a process group
the group's rank decides; without one the process is rank 0 unless
``-rank`` says otherwise.
"""

from __future__ import annotations

import os
from time import gmtime, strftime
from typing import Any, Dict


def is_rank0(params: Dict[str, Any]) -> bool:
    """True on the process that owns logs and TensorBoard: rank 0 of an
    initialized ``torch.distributed`` process group, else the process
    whose ``-rank`` is 0."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return not int(params.get('rank') or 0)


def init_log_file(params: Dict[str, Any]) -> None:
    os.makedirs(params['save_path'], exist_ok=True)
    params['log_file'] = os.path.join(
        params['save_path'], strftime('%d-%b-%y-%X-%a', gmtime()) + ".txt")
    if is_rank0(params):
        with open(params['log_file'], 'w') as f:
            f.write(str(params).replace(",", "\n"))
            f.write("\n\n ============= Details ========== \n"
                    + str(params.get('details', '')))


def log_line(params: Dict[str, Any], line: str, all_ranks: bool = False) -> None:
    if is_rank0(params) or all_ranks:
        lf = params.get('log_file')
        if lf and lf != "None":
            with open(lf, 'a') as f:
                f.write(line + "\n")
        print(line, flush=True)
