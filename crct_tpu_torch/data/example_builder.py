"""Per-sample example construction: fig-feature dict + QA pair -> fixed-shape arrays.

The PyTorch port's copy of ``crct_tpu/data/example_builder.py``. This is a
faithful, pure-numpy re-derivation of the reference's example
semantics (CRCT/fig_dataloader.py + CRCT/utils.py:50-225): caption assembly
(title / axis labels / ticks / legend with normalized locations), question
tokenization with OCR-substring location annotation, candidate-answer
construction (train: GT or random negative; eval: all candidates), the
hbar->vbar transpose reduction, regression target + per-chart y-scale +
tolerance derivation, and the text/image encoders with fixed-shape padding.

All shapes are static (max_seq_len tokens, max_vis_features regions,
EVAL_PADDED_SIZE candidates), so every model dispatch has one of a few
shapes. Randomness is explicit
via a numpy Generator for reproducibility (the reference used unseeded
global RNGs; distributions match).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from crct_tpu_torch.data.tokenizer import WordPieceTokenizer

# Detector class names of chart elements; token types are ['Q','A'] + these
# (reference fig_dataloader.py:20-22). 'Q' is encoded as -1.
FIG_CLASSES = ['bar', 'dot_line', 'legend_label', 'line', 'preview', 'title',
               'xlabel', 'xticklabel', 'ylabel', 'yticklabel', 'x_axis', 'y_axis']
TOKEN_TYPES = ['Q', 'A'] + FIG_CLASSES

# Fixed answer vocabularies (reference fig_dataloader.py:35-51).
FIXED_VOCAB_STRUCTURAL = [2, 'Yes', 'No', 'vertical', 5, 'center right', 4,
                          'horizontal', 'bottom right', 7, 6, 'bottom center',
                          'bottom left', 0, 8, 3, 1, 'top right', 12, 10, 9, 11,
                          18, 14, 15, 13, 17, 16, 20, 24, 19, 23, 22, 21]
FIXED_VOCAB_DVQA = ['yes', 'no', 'zero', 'two', 'three', 'one', 'four', 'five',
                    'six', 'seven', 'eight', 'nine']

REG_TOKEN = "="          # the <r> regression answer token (self.R)
POS, NEG = 0, 1          # next-sentence labels
IMG_TOKEN_CLASS = 1000   # whole-image token class written by the extractor
EVAL_PADDED_SIZE = 120   # candidate fan-out pad (fig_dataloader.py:76)
MAX_SEP_LEN = 50         # sep-index pad (utils.py:105)

PADDING_TXT = ['tokens', 'segments', 'sep_indices', 'mask',
               'next_sentence_labels', 'hist_len', 'loc', 'legend_belonging_t']
PADDING_VIS = ['image_feat', 'image_loc', 'image_mask', 'image_target',
               'image_label', 'legend_belonging_v', 'R']


def fig_type_to_id(str_type: str) -> int:
    """line=0, vbar=1, hbar=2, dot=3 (reference fig_dataloader.py:720-730)."""
    mapping = {'line': 0, 'vbar': 1, 'hbar': 2, 'dot': 3, 'dot_line': 3}
    return mapping[str_type]


def get_token_type(name: str) -> int:
    """Class id of a token type; 'Q' is -1 (fig_dataloader.py:158-161)."""
    return TOKEN_TYPES.index(name) if name != 'Q' else -1


def _is_float(s: Any) -> bool:
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False


class ExampleBuilder:
    """Builds fixed-shape training/eval examples from raw records."""

    def __init__(self, params: Dict[str, Any], tokenizer: WordPieceTokenizer):
        self.params = params
        self.tokenizer = tokenizer
        self.max_seq_len = params['max_seq_len']
        self.max_regions = params['max_vis_features']
        if params['dataset'] == 'dvqa':
            fixed_vocab: List[Any] = list(FIXED_VOCAB_DVQA)
        else:
            fixed_vocab = list(FIXED_VOCAB_STRUCTURAL)
        fixed_vocab.append(REG_TOKEN)
        self.fixed_vocab = [str(p) for p in fixed_vocab]
        self.CLS = tokenizer.cls_id
        self.SEP = tokenizer.sep_id
        self.MASK = tokenizer.mask_id

    # ------------------------------------------------------------------
    # caption / question assembly
    # ------------------------------------------------------------------
    def get_fig_caption(self, text_feat: Dict[str, Any], is_hbar: bool = False):
        """Assemble (tokens, loc, type) triplets for the chart's text elements.

        Returns (caption, tot_len, possible_answers, ticks_values); mirrors
        fig_dataloader.py:163-230 including the axis-orientation loc encoding.
        """
        params = self.params
        caption: List[Tuple[List[int], Any, int]] = []
        possible_answers: List[Tuple[str, Optional[List[float]]]] = []
        ticks_values = {'x_axis': [], 'y_axis': []}
        tot_len = 0

        if params['dataset'] != 'figure_qa' and 'title' in text_feat:
            assert isinstance(text_feat['title'], dict), "Title location"
            title_txt = text_feat['title']['text']
            title_loc = list(text_feat['title']['bbox'])
            title = self.tokenizer.encode(title_txt)
            caption.append((title, title_loc, get_token_type('title')))
            tot_len += len(title) + 2
            if params['dataset'] != 'dvqa':
                possible_answers.append((title_txt, None))

        for ax in ['x_axis', 'y_axis']:
            if ax not in text_feat:
                continue
            if params['dataset'] != 'figure_qa':
                axis_label_loc = [0.5, 0, 0.5, 0] if (
                    (ax == 'y_axis' and is_hbar) or (ax == 'x_axis' and not is_hbar)
                ) else [0, 0.5, 0, 0.5]
                if len(text_feat[ax]['label']) > 0:
                    possible_answers.append((text_feat[ax]['label'], None))
                    axis_label = self.tokenizer.encode(text_feat[ax]['label'])
                    caption.append((axis_label, axis_label_loc,
                                    get_token_type(ax[0] + "label")))
                    tot_len += len(axis_label) + 1
            for t, l in text_feat[ax]['ticks']:
                if l > 0:
                    try:
                        ticks_values[ax].append((float(t), float(l)))
                    except (TypeError, ValueError):
                        pass
                tick_label = self.tokenizer.encode(t)
                if params['dataset'] == 'dvqa':
                    orientation = ((ax == 'y_axis' and not text_feat['values_are_x'])
                                   or (ax == 'x_axis' and text_feat['values_are_x']))
                    tick_label_loc = [0, l, 0, l] if orientation else [l, 0, l, 0]
                else:
                    tick_label_loc = [l, 0, l, 0] if (
                        (ax == 'y_axis' and is_hbar) or (ax == 'x_axis' and not is_hbar)
                    ) else [0, l, 0, l]
                if ax == 'x_axis' or '_cls' in params['qa_file']:
                    possible_answers.append((t, tick_label_loc))
                caption.append((tick_label, tick_label_loc,
                                get_token_type(ax[0] + 'ticklabel')))
                tot_len += len(tick_label) + 1

        if 'legend' in text_feat:
            for i in range(len(text_feat['legend']['label'])):
                legend_label = self.tokenizer.encode(text_feat['legend']['label'][i])
                legend_label_loc = list(text_feat['legend']['bbox'][i])
                possible_answers.append(
                    (text_feat['legend']['label'][i], legend_label_loc))
                caption.append((legend_label, legend_label_loc,
                                get_token_type('legend_label')))
                tot_len += len(legend_label) + 1

        return caption, tot_len, possible_answers, ticks_values

    def tokenize_question_with_loc(self, ocr_features, qa_pair):
        """Annotate question substrings that match OCR'd chart text with their
        box locations (fig_dataloader.py:468-498)."""
        triplets = []
        q = qa_pair['question_string']
        ocr_in_question = []
        for string, loc in ocr_features:
            if loc is None:
                continue
            start_id = q.find(string)
            if start_id > -1:
                ocr_in_question.append((string, loc, start_id))
        ocr_in_question.sort(key=lambda x: x[-1])
        prev_id = 0
        for string, loc, start_id in ocr_in_question:
            if start_id > prev_id:
                triplets.append((self.tokenizer.encode(q[prev_id:start_id]),
                                 [0, 0, 0, 0], get_token_type('Q')))
            triplets.append((self.tokenizer.encode(q[start_id:start_id + len(string)]),
                             loc, get_token_type('Q')))
            prev_id = start_id + len(string)
        if prev_id < len(q) - 1:
            triplets.append((self.tokenizer.encode(q[prev_id:]),
                             [0, 0, 0, 0], get_token_type('Q')))

        tokens: List[int] = []
        locs: List[Any] = []
        for toks, loc, _ in triplets:
            locs += [loc] * len(toks)
            tokens += toks
        return tokens, locs, get_token_type('Q')

    # ------------------------------------------------------------------
    # candidate answers
    # ------------------------------------------------------------------
    def right_answer_utterance(self, caption, qa_pair, possible_answers):
        utt = list(caption)
        if str(qa_pair['answer']) not in possible_answers:
            tokenized = self.tokenizer.encode(REG_TOKEN)
        else:
            tokenized = self.tokenizer.encode(str(qa_pair['answer']))
        utt.append((tokenized, [0, 0, 0, 0], get_token_type('A')))
        return utt, POS

    def random_answer_utterance(self, caption, qa_pair, possible_answers, rng):
        utt = list(caption)
        ans = str(qa_pair['answer'])
        if ans.lower() in ('yes', 'no'):
            random_ans = 'yes' if ans.lower() == 'no' else 'no'
        else:
            random_ans = str(rng.choice(possible_answers))
            while ans == random_ans and len(possible_answers) > 1:
                random_ans = str(rng.choice(possible_answers))
        utt.append((self.tokenizer.encode(random_ans), [0, 0, 0, 0],
                    get_token_type('A')))
        return utt, NEG

    def cat_answers(self, qa_pair, caption, possible_answers, *,
                    train: bool, negative: bool, rng: np.random.Generator):
        """Train: one utterance (GT or random negative); eval: all candidates
        (fig_dataloader.py:271-293)."""
        if train:
            if negative:
                return [self.random_answer_utterance(caption, qa_pair,
                                                     possible_answers, rng)]
            return [self.right_answer_utterance(caption, qa_pair, possible_answers)]
        gt_ans = (str(qa_pair['answer']) if str(qa_pair['answer']) in possible_answers
                  else REG_TOKEN)
        utterances = []
        for ans in possible_answers:
            utt = list(caption)
            label = POS if gt_ans == str(ans) else NEG
            utt.append((self.tokenizer.encode(ans), [0, 0, 0, 0],
                        get_token_type('A')))
            utterances.append((utt, label))
        return utterances

    # ------------------------------------------------------------------
    # encoders (reference utils.py:105-225)
    # ------------------------------------------------------------------
    def encode_text_input(self, utterances, locations, token_types, *,
                          mask_prob: float, rng: np.random.Generator):
        """CLS framing, per-utterance SEP, 4-d locs with legend-belonging split,
        random question-token masking, fixed-shape padding."""
        L = self.max_seq_len
        token_ids = [self.CLS]
        segment_ids = [0]
        tokens_loc: List[Sequence[float]] = [[0, 0, 0, 0]]
        masked = [0]
        sep_indices: List[int] = []
        cur_sep = 0
        for utt, loc, seg in zip(utterances, locations, token_types):
            if len(loc) == 0:
                loc = [0, 0, 0, 0]
            if mask_prob > 0 and seg == -1:
                masked.extend((rng.random(len(utt)) < mask_prob).astype(int).tolist())
            else:
                masked.extend([0] * len(utt))
            token_ids.extend(utt)
            segment_ids.extend([seg] * len(utt))
            per_token = not (len(loc) == 0 or not isinstance(loc[0], (list, tuple, np.ndarray)))
            if per_token:
                tokens_loc.extend(loc)
                tokens_loc.append(loc[0])
            else:
                tokens_loc.extend([loc] * len(utt))
                tokens_loc.append(loc)
            token_ids.append(self.SEP)
            segment_ids.append(seg)
            masked.append(0)
            cur_sep += len(utt) + 1
            sep_indices.append(cur_sep)
        assert len(segment_ids) == len(tokens_loc) == len(token_ids) == len(masked)
        assert len(token_ids) == sep_indices[-1] + 1
        # over-long sequences truncate silently, matching the torch slice
        # clamping in the reference's list2tensorpad (utils.py:50-56)
        n = min(len(token_ids), L)
        tokens = np.zeros(L, np.int32)
        tokens[:n] = token_ids[:n]
        masked_tokens = np.full(L, -1, np.int32)
        marr = np.zeros(L, np.int32)
        marr[:n] = masked[:n]
        sel = marr == 1
        masked_tokens[sel] = tokens[sel]
        tokens[sel] = self.MASK
        segments = np.zeros(L, np.int32)
        segments[:n] = segment_ids[:n]
        seps = np.zeros(MAX_SEP_LEN, np.int32)
        seps[:min(len(sep_indices), MAX_SEP_LEN)] = sep_indices[:MAX_SEP_LEN]

        padded_locs = np.zeros((L, 4), np.float32)
        legend_belonging = np.zeros((L, 1), np.int32)
        for i, lc in enumerate(tokens_loc):
            if len(lc) > 4:
                legend_belonging[i, 0] = int(lc[4])
                tokens_loc[i] = list(lc[:4])
        padded_locs[:min(len(tokens_loc), L)] = np.asarray(
            [list(lc[:4]) for lc in tokens_loc], np.float32)[:L]
        return tokens, segments, seps, padded_locs, masked_tokens, legend_belonging

    def encode_image_input(self, features, legend_belonging, boxes, classes, *,
                           mask_prob: float, rng: np.random.Generator):
        """Pad regions to max_regions, random feature masking, region mask
        (reference utils.py:174-225)."""
        R = self.max_regions
        num_boxes = min(len(boxes), R)
        mix_boxes = np.zeros((R, boxes.shape[-1]), np.float32)
        mix_feats = np.zeros((R, features.shape[-1]), np.float32)
        mix_cls = np.zeros((R,), np.int32)
        mix_belong = np.zeros((R,), np.int32)
        mix_boxes[:num_boxes] = boxes[:num_boxes]
        mix_feats[:num_boxes] = features[:num_boxes]
        mix_cls[:num_boxes] = np.asarray(classes).reshape(-1)[:num_boxes]
        if legend_belonging is not None:
            mix_belong[:num_boxes] = np.asarray(legend_belonging,
                                                np.int32)[:num_boxes]
        output_label = np.full(R, -1, np.int32)
        if mask_prob > 0:
            probs = rng.random(num_boxes)
            hit = probs < mask_prob
            output_label[:num_boxes][hit] = 1
            zero_out = hit & (probs / max(mask_prob, 1e-9) < 0.9)
            mix_feats[:num_boxes][zero_out] = 0
        # ensure at least one predicted region (reference utils.py:215), but
        # never the <IMG> token at slot 0 (utils.py:217)
        output_label[int(rng.integers(1, R))] = 1
        output_label[0] = 0
        image_mask = np.zeros(R, np.float32)
        image_mask[:num_boxes] = 1.0
        return mix_feats, mix_boxes, image_mask, mix_cls, output_label, mix_belong

    # ------------------------------------------------------------------
    # hbar handling
    # ------------------------------------------------------------------
    def is_hbar(self, fig_feat: Dict[str, Any]) -> bool:
        """Bar-majority + widest-bar aspect heuristic (fig_dataloader.py:500-522)."""
        cls = fig_feat['class']
        if cls is None or cls.shape[0] <= 1:
            return False
        if 'x_axis' not in fig_feat['text_feat']:
            return False
        vis_cls = cls != IMG_TOKEN_CLASS
        ds = self.params['dataset']
        if ds == 'plotqa':
            num_bars = np.sum((8 <= cls[vis_cls]) & (cls[vis_cls] <= 80))
        elif ds == 'plotqa_colorless':
            num_bars = np.sum(cls[vis_cls] == 0)
            if num_bars > 0:
                num_bars = np.sum((cls[vis_cls] == 0) | (cls[vis_cls] == 4))
        elif ds == 'dvqa':
            num_bars = np.sum((62 <= cls[vis_cls]) & (cls[vis_cls] <= 120))
        else:
            raise AssertionError(ds)
        if num_bars / (cls.shape[0] - 1) >= 0.5:
            bbox = fig_feat['vis_bbox']
            x_len = bbox[vis_cls, 2] - bbox[vis_cls, 0]
            y_len = bbox[vis_cls, 1] - bbox[vis_cls, 3]
            widest = np.argmax(x_len * y_len)
            if y_len[widest] / x_len[widest] < 1:
                return True
        return False

    @staticmethod
    def apply_hbar_transpose(fig_feat: Dict[str, Any], transpose_bbox: bool) -> None:
        """Swap x/y axes metadata (and optionally transpose boxes) in-place
        (fig_dataloader.py:528-535)."""
        tf = fig_feat['text_feat']
        tf['x_axis'], tf['y_axis'] = tf['y_axis'], tf['x_axis']
        for ax in ['x_axis', 'y_axis']:
            tf[ax]['w'], tf[ax]['h'] = tf[ax]['h'], tf[ax]['w']
        if transpose_bbox:
            fig_feat['vis_bbox'] = fig_feat['vis_bbox'][:, [3, 2, 1, 0]]

    # ------------------------------------------------------------------
    # full example assembly
    # ------------------------------------------------------------------
    @staticmethod
    def _cow_fig_feat(fig_feat: Dict[str, Any]) -> Dict[str, Any]:
        """Copy-on-write view of a cached feature record. The ONLY in-place
        mutations on the tree are apply_hbar_transpose's axis swaps (the
        text_feat mapping + the two axis dicts), the vis_bbox reassignment,
        and ColorMapping.feature_replace's ticks/legend-label reassignments,
        so those dicts are copied and the large arrays (vis_feat [N,1024],
        vis_bbox, class) stay shared — a full deepcopy here was ~30% of
        builder time."""
        out = dict(fig_feat)
        tf = fig_feat.get('text_feat')
        if isinstance(tf, dict):
            new_tf = dict(tf)
            for k in ('x_axis', 'y_axis', 'legend'):
                if isinstance(new_tf.get(k), dict):
                    new_tf[k] = dict(new_tf[k])
            out['text_feat'] = new_tf
        return out

    def get_possible_answers(self, fig_feat: Dict[str, Any]) -> List[str]:
        """All candidate strings for a chart: its texts + fixed vocab
        (fig_dataloader.py:443-459)."""
        fig_feat = self._cow_fig_feat(fig_feat)
        is_hbar = self.params['dataset'] != 'dvqa' and self.is_hbar(fig_feat)
        if is_hbar:
            self.apply_hbar_transpose(fig_feat, self.params['hbar_bbox_t'])
        _, _, possible, _ = self.get_fig_caption(fig_feat['text_feat'],
                                                 is_hbar=is_hbar)
        possible = [txt[0] for txt in possible]
        return possible + [o for o in self.fixed_vocab if o not in possible]

    def build(self, fig_feat: Dict[str, Any], qa_pair: Dict[str, Any], *,
              split: str = 'train', negative: bool = False,
              get_all_answers: bool = False, qa_ind: int = -1,
              rng: Optional[np.random.Generator] = None) -> Dict[str, Any]:
        """Full __getitem__ equivalent (fig_dataloader.py:425-695)."""
        params = self.params
        rng = rng or np.random.default_rng(0)
        fig_feat = self._cow_fig_feat(fig_feat)
        text_feat = fig_feat['text_feat']
        train = split == 'train' and not get_all_answers

        is_hbar = False
        if params['dataset'] == 'plotqa' and self.is_hbar(fig_feat):
            is_hbar = True
            self.apply_hbar_transpose(fig_feat, params['hbar_bbox_t'])

        caption, tot_len, ocr_features, ticks_values = self.get_fig_caption(
            text_feat, is_hbar=is_hbar)
        caption.append(self.tokenize_question_with_loc(ocr_features, qa_pair))

        if params['dataset'] != 'figure_qa':
            possible_answers = [txt[0] for txt in ocr_features]
            if params['fixed_vocab']:
                possible_answers = list(self.fixed_vocab)
            else:
                possible_answers = possible_answers + [
                    o for o in self.fixed_vocab if o not in possible_answers]
            if '_REGS' in params['qa_file']:
                possible_answers = [REG_TOKEN, REG_TOKEN]
        else:
            possible_answers = ['Yes', 'No']

        if params['binary_answers']:
            gt_answer = qa_pair.get('answer', -1)
            utterances = [(caption, gt_answer)]
        else:
            utterances = self.cat_answers(qa_pair, caption, possible_answers,
                                          train=(split == 'train' and not get_all_answers),
                                          negative=negative, rng=rng)

        mask_prob = params['mask_prob'] if split == 'train' else 0.0
        enc = [self.encode_text_input(*zip(*utt), mask_prob=mask_prob, rng=rng)
               for utt, _ in utterances]
        labels = np.asarray([lab for _, lab in utterances], np.int32)

        item: Dict[str, Any] = {}
        item['id'] = np.asarray([qa_ind], np.int64)
        item['tokens'] = np.stack([e[0] for e in enc])
        item['segments'] = np.stack([e[1] for e in enc])
        item['sep_indices'] = np.stack([e[2] for e in enc])
        item['mask'] = np.stack([e[4] for e in enc])
        item['loc'] = np.stack([e[3] for e in enc])
        item['legend_belonging_t'] = np.stack([e[5] for e in enc])
        item['hist_len'] = np.asarray(
            [len(utt) - 1 for utt, _ in utterances], np.int32)
        item['next_sentence_labels'] = labels

        if len(utterances) == 1:
            for k in ['tokens', 'segments', 'sep_indices', 'mask', 'loc',
                      'legend_belonging_t']:
                item[k] = item[k][0]

        item['gt'] = str(qa_pair['answer'])
        gt_ind = (possible_answers.index(item['gt'])
                  if (item['gt'] in possible_answers
                      and '_REGS' not in params['qa_file']) else -1)
        if gt_ind == -1 and not params['BOT_MODE']:
            if not _is_float(item['gt']):
                gt_ind = int(rng.integers(len(possible_answers)))
                if (params['dataset'] != 'dvqa' and not params['binary_answers']
                        and not params['BOT_MODE']):
                    # unanswerable GT relabelled NEG (fig_dataloader.py:593-601)
                    item['next_sentence_labels'] = item['next_sentence_labels'].copy()
                    item['next_sentence_labels'][0] = NEG

        if gt_ind == -1 and (not params['binary_answers']
                             and '_cls' not in params['qa_file']):
            gt_ind = possible_answers.index(REG_TOKEN)
            yt = ticks_values['y_axis']
            # NOTE: the reference computes a per-chart half-mean-tick-gap
            # tolerance here and then DISCARDS it (fig_dataloader.py:608-609
            # — a dead local); R[2] always carries the constant -tol_margin.
            # We skip the dead computation; behavior is identical.
            # real-OCR robustness: a misread tick can carry p == 0 (skip
            # it) or all-zero values (y scale 0) — either would crash the
            # reference formula with a Python ZeroDivisionError; such a
            # chart degrades to the same fallback scale as the no-ticks
            # case instead of killing the run (hit by --OCR extraction,
            # reference surface Detector/extract_features.py:579-627)
            y_length = [abs(float(v) / float(p)) for v, p in yt
                        if float(p) != 0]
            if params['BOT_MODE'] and qa_pair['answer'] is None:
                gt_value = 1.0
            else:
                gt_value = float(item['gt'])
            y = float(np.mean(y_length)) if y_length else 0.0
            if y == 0 or not np.isfinite(y):
                item['R'] = [gt_value, True, 1.0,
                             float(item['gt']) if float(item['gt']) != 0 else 1.0]
            else:
                item['R'] = [gt_value, True, params['tol_margin'], y]
            item['gt'] = np.asarray([gt_value], np.float32)
            item['reg_target'] = np.asarray([item['R'][0] / item['R'][3]], np.float32)
            if params['CE_REG']:
                item['R'][0] = params['dvqa_floats'].index(item['R'][0])
        else:
            item['R'] = [0, False, 0, 0]
            item['gt'] = np.asarray([0], np.float32)
            item['reg_target'] = np.asarray([0], np.float32)

        item['needs_reg'] = np.asarray([bool(item['R'][1])])
        item['tolerance_margin'] = np.asarray([item['R'][2]], np.float32)
        item['R'] = np.asarray(item['R'], np.float32)

        if params['dataset'] == 'figure_qa':
            if 'answer' not in qa_pair:
                item['gt_id'] = np.asarray([-1], np.int64)
            else:
                item['gt_id'] = np.asarray([1 - qa_pair['answer']], np.int64)
        else:
            item['gt_id'] = np.asarray([gt_ind], np.int64)
        item['num_ans'] = np.asarray([len(possible_answers)], np.int64)

        if 'plotqa' in params['dataset']:
            item['qid'] = str(qa_pair['qid'])
            item['qa_type'] = qa_pair['type'].replace('dot_line', 'dot')
            item['fig_type_id'] = np.asarray([fig_type_to_id(qa_pair['type'])],
                                             np.int64)
        elif params['dataset'] == 'dvqa':
            item['qid'] = {'structure': 'S7', 'data': 'D14'}.get(
                qa_pair['template_id'], 'A4')
            item['qa_type'] = 'vbar'

        # ---- visual side -------------------------------------------------
        item.update(self._encode_visual(fig_feat, split, rng))

        if params['dataset'] == 'figure_qa':
            area = np.zeros(self.max_regions, np.float64)
            if 'pie' in text_feat:
                areas = [0 if a is None else a for a in text_feat['pie']['areas']]
                if areas:
                    a = np.asarray(areas, np.float64)
                    e = np.exp(a - a.max())
                    area[:len(areas)] = e / e.sum()
            item['area'] = area

        # ---- eval candidate fan-out pad ----------------------------------
        # visual keys broadcast over the candidates (fig_dataloader.py:690-693);
        # with -fixed_vocab the fan-out is already constant (vocab size), so
        # the 120-candidate padding is skipped (fig_dataloader.py:584)
        if (get_all_answers or split != 'train') and not params['binary_answers']:
            n = int(item['num_ans'][0])
            for key in PADDING_VIS:
                item[key] = np.broadcast_to(
                    item[key], (n,) + item[key].shape).copy()
            if not params['fixed_vocab']:
                for key in PADDING_TXT + PADDING_VIS:
                    item[key] = pad_first_dim(item[key], EVAL_PADDED_SIZE)
                # a chart with >120 candidate texts truncates to the pad;
                # num_ans must clamp with it (torch's x[i, :num_ans] slicing
                # clamps silently in the reference, so an out-of-pad GT can
                # simply never win — same semantics here). Unclamped, the
                # flattened row indexing would read the NEXT question's rows.
                item['num_ans'] = np.minimum(item['num_ans'],
                                             EVAL_PADDED_SIZE)
        return item

    def _encode_visual(self, fig_feat, split, rng):
        """Reshape/encode the visual features (fig_dataloader.py:308-361)."""
        params = self.params
        cls = np.asarray(fig_feat['class']).copy()
        assert cls[0] in (100, 999, IMG_TOKEN_CLASS)
        bbox = np.asarray(fig_feat['vis_bbox'], np.float32).copy()
        bbox[0, :4] = 0  # <IMG> token needs no location
        if bbox.shape[-1] >= 5:
            legend_belonging_v = bbox[:, 4]
        else:
            legend_belonging_v = np.zeros(bbox.shape[0])
        assert cls[0] == IMG_TOKEN_CLASS, cls
        cls[0] = params['categories']
        if params['dataset'] == 'dvqa':
            cls = cls.copy()
            cls[cls >= 62] -= 58
            cls[0] = params['categories']
        mask_prob_img = params['mask_prob_img'] if split == 'train' else 0.0
        feats, boxes, image_mask, image_target, image_label, belong = \
            self.encode_image_input(np.asarray(fig_feat['vis_feat'], np.float32),
                                    legend_belonging_v, bbox[:, :4], cls,
                                    mask_prob=mask_prob_img, rng=rng)
        return {
            'image_feat': feats, 'image_loc': boxes, 'image_mask': image_mask,
            'image_target': image_target, 'image_label': image_label,
            'legend_belonging_v': belong,
        }


def pad_first_dim(x: np.ndarray, to: int) -> np.ndarray:
    """Zero-pad (or truncate) the leading dim to a fixed size."""
    shape = (to,) + tuple(x.shape[1:])
    out = np.zeros(shape, dtype=x.dtype)
    n = min(x.shape[0], to)
    out[:n] = x[:n]
    return out
