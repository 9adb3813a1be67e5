"""Interactive PlotQA bot of the PyTorch port (reference
CRCT/Interactive_demo.py; the port of ``crct_tpu/cli/demo.py``).

A REPL over a loaded split and checkpoint: pick a figure id, pick one of
its questions (or type a free-form one), get the ranked answer, the
regression output when the answer is out of vocabulary, and every
candidate's probability. Scores on the card through the eval step unless
``-device cpu`` is given:

    python -m crct_tpu_torch.cli.demo -qa_file qa_pairs_test.npy \\
        -dataset_config config/plotqa.json -eval_set test \\
        -start_checkpoint crct.ckpt [-device cpu | -cuda_num N]

``-start_checkpoint`` loads as ``cli.evaluate``'s does: the port's, a
reference ``crct.ckpt`` or a JAX package checkpoint, in transfer mode.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional

import numpy as np

from crct_tpu_torch.config import read_command_line
from crct_tpu_torch.data.dataset import ChartQADataset, collate
from crct_tpu_torch.data.example_builder import REG_TOKEN
from crct_tpu_torch.models.crct import CRCTModel
from crct_tpu_torch.train.eval_loop import (_chunk_rows, _flatten_valid_rows,
                                            make_eval_step,
                                            resolve_eval_chunk)
from crct_tpu_torch.utils.device import params_device


class PlotQAModel:
    """Single-question inference (reference Interactive_demo.Model).
    ``model`` defaults to the eval model of ``-start_checkpoint`` (else a
    deterministic init from ``-seed``) on ``device``."""

    def __init__(self, params: Dict[str, Any], dataset: ChartQADataset,
                 model: Optional[CRCTModel] = None, *, device="cuda"):
        self.params = params
        self.dataset = dataset
        if model is None:
            from crct_tpu_torch.cli.evaluate import load_eval_model
            model = load_eval_model(params, device)
        self.model = model.eval()
        self.eval_step = make_eval_step(self.model)
        self.chunk = resolve_eval_chunk(params)

    def forward(self, qa_pair: Dict[str, Any],
                fig_feat: Optional[Dict] = None) -> Dict[str, Any]:
        ds = self.dataset
        if fig_feat is None:
            fig_feat = ds.get_fig_feat(qa_pair["image_index"])
        item = ds.builder.build(fig_feat, qa_pair, split=ds.split,
                                get_all_answers=True, qa_ind=-1,
                                rng=np.random.default_rng(0))
        batch = collate([item])
        rows, _ = _flatten_valid_rows(batch)

        nsp_list, reg_out_list, reg5_list = [], [], []
        for piece, valid in _chunk_rows(rows, self.chunk):
            nsp, reg_out, reg5, _ = self.eval_step(piece)
            nsp_list.append(nsp[:valid].float().cpu().numpy())
            reg_out_list.append(reg_out[:valid].float().cpu().numpy())
            reg5_list.append(reg5[:valid].float().cpu().numpy())
        nsp_probs = np.concatenate(nsp_list)
        reg_out = np.concatenate(reg_out_list)
        reg5 = np.concatenate(reg5_list)

        n = int(batch["num_ans"][0, 0])
        ans_id = int(np.argmax(nsp_probs[:n]))
        # Reference-parity quirk: the displayed certainties are a SECOND
        # softmax over values that are already per-candidate NSP
        # probabilities (Interactive_demo.py:208 applies F.softmax to
        # nsp_probs[:, 0]), squashing them toward uniform. Ranking is
        # unaffected; kept so the demo prints what the reference bot does.
        certainty = np.exp(nsp_probs[:n] - nsp_probs[:n].max())
        certainty = certainty / certainty.sum()

        needs_reg = bool(np.asarray(batch["needs_reg"]).reshape(-1)[0])
        gt_id = int(batch["gt_id"][0, 0])
        nsp_right = ans_id == gt_id
        reg_loss = float(reg5[ans_id])
        reg_right = (reg_loss <= 0.05) and needs_reg
        correct = nsp_right and ((not needs_reg) or reg_right)

        answer_options = ds.get_possible_answers(qa_pair["image_index"],
                                                 fig_feat)
        all_answers = sorted(zip(certainty.tolist(), answer_options),
                             key=lambda x: -x[0])
        return {
            "nsp_right": nsp_right,
            "is_correct": correct,
            "is_reg": needs_reg,
            "reg_loss": reg_loss,
            "reg_output": float(reg_out[ans_id]),
            "cls_output": answer_options[ans_id],
            "all_answers": all_answers,
        }


class PlotQABot:
    """REPL (reference PlotQA_Bot.loop, Interactive_demo.py:63-111)."""

    def __init__(self, params: Dict[str, Any], split: str = "test", *,
                 model: Optional[CRCTModel] = None, device="cuda"):
        self.params = params
        self.dataset = ChartQADataset(params, split, init_split=split)
        self.dataset.get_all_answers = True
        self.model = PlotQAModel(params, self.dataset, model, device=device)
        self.img_to_qas: Dict[int, list] = {}
        for qa in self.dataset.qa[self.dataset.split]:
            self.img_to_qas.setdefault(qa["image_index"], []).append(qa)

    def loop(self):
        """Runs until the input ends (EOF or the scripted feed runs out)."""
        while True:
            image_id = int(input(
                f"Type the figure id in the {self.dataset.split} folder:\n"))
            qas = self.img_to_qas.get(image_id, [])
            for i, qa in enumerate(qas):
                print(f"<{i + 1}>: {qa['question_string']}")
            if not qas:
                print("Nothing to ask about this image, try another one :(")
                continue
            while True:
                usr = input("Choose a question id or type a question: \n")
                try:
                    qa_pair = qas[int(usr) - 1]
                    print(qa_pair["question_string"])
                except (ValueError, IndexError):
                    qa_pair = {"question_string": str(usr),
                               "image_index": image_id, "answer": None,
                               "qid": None, "type": "dot"}
                pred = self.model.forward(qa_pair)
                if qa_pair["qid"] is None:
                    out = (pred["reg_output"]
                           if str(pred["cls_output"]) == REG_TOKEN
                           else pred["cls_output"])
                    print(f"<CRCT>:  {out}")
                else:
                    print(f"<GT>:  {qa_pair['answer']}")
                    prediction = (pred["reg_output"] if pred["is_reg"]
                                  else pred["cls_output"])
                    line = f"<CRCT>: {prediction}"
                    if pred["is_reg"] and pred["nsp_right"]:
                        sign = "+" if pred["reg_output"] > float(
                            qa_pair["answer"]) else "-"
                        line += (f". (Error: {sign}"
                                 f"{round(pred['reg_loss'] * 100, 2)}%)")
                    print(line)
                print("-" * 10, "[Answers probabilities]", "-" * 10)
                print(pred["all_answers"])
                print("--------------")


def main(argv=None):  # pragma: no cover - interactive
    if argv is None and len(sys.argv) == 1:
        argv = ["-qa_file", "qa_pairs_test.npy", "-eval_batch_size", "100",
                "-num_workers", "0", "-save_name", "temp",
                "-dataset_config", "config/plotqa.json", "-eval_set", "test",
                "-start_checkpoint", "crct.ckpt", "-BOT_MODE"]
    params = read_command_line(argv)
    bot = PlotQABot(params, split=params["eval_set"],
                    device=params_device(params))
    try:
        bot.loop()
    except (EOFError, KeyboardInterrupt):
        print()


if __name__ == "__main__":
    main()
