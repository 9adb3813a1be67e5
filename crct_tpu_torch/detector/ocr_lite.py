"""Dependency-free template-matching OCR for chart text (fallback engine).

The port's copy of ``crct_tpu/detector/ocr_lite.py``; PIL and scipy are
imported inside the functions that need them.

The reference's real-OCR mode shells out to the Tesseract binary via
pytesseract (reference Detector/extract_features.py:23,602). That binary
is a heavyweight native dependency that is frequently absent; without it
the `--OCR` path could never run end to end. This module is a
self-contained engine for the same crops: it renders glyph templates with
the SAME PIL default font that synthetic chart text is drawn with and
decodes a crop by dynamic programming over columns.

Algorithm (pure numpy, no accelerator involvement — OCR is an offline
host-side step, SURVEY.md §2.3):

  1. Templates: every charset glyph rendered at integer and half-pixel
     x-offsets (anti-aliased text lands on fractional advances).
  2. Match errors for every (glyph, line-origin dy, column x) come from
     one einsum per template width over sliding windows of the crop.
  3. Per line origin: Viterbi over columns — each column is either
     *explained* by a glyph window (cost = residual squared error + a
     per-glyph constant) or *skipped* (cost = its ink energy), so phantom
     glyphs over blank space and silently-consumed ink are both
     impossible by construction. Spaces come from gaps between decoded
     glyph advances.
  4. The lowest-cost line wins.

Exact on text rendered with the same font (see tests); approximate on
other fonts — it is a FALLBACK so the real-OCR pipeline (crop dilation,
vertical-tick rotation, numeric/color cleanup in detector/ocr.py) can
run end to end without Tesseract, not a Tesseract replacement. When
pytesseract is importable it is preferred automatically.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

CHARSET = ("0123456789abcdefghijklmnopqrstuvwxyz"
           "ABCDEFGHIJKLMNOPQRSTUVWXYZ.,-%()+/:?'&$*=;")
LINE_HEIGHT = 14          # template canvas rows (PIL default font is ~11px)
GLYPH_COST = 0.15         # per-glyph constant (favors fewer, fuller glyphs)
SLACK_COST = 0.08         # off-by-one advance tolerance penalty
SKIP_BASE = 0.02          # per-column skip floor
SPACE_GAP = 2             # unexplained columns between glyphs => space
# candidate pruning: keep (glyph, position) pairs whose residual is well
# below the template's own ink energy — blanks and wrong glyphs prune out
PRUNE_FRAC = 0.6
PRUNE_ABS = 0.35

_ENGINE: Optional["TemplateOCR"] = None


class TemplateOCR:
    """Template-matching line decoder over the PIL default font."""

    def __init__(self) -> None:
        from PIL import Image, ImageDraw, ImageFont
        self._font = ImageFont.load_default()
        meas = ImageDraw.Draw(Image.new("L", (1, 1)))
        by_width: Dict[int, Tuple[list, list]] = {}
        for ch in CHARSET:
            adv = meas.textlength(ch, font=self._font)
            for fx in (0.0, 0.5):   # sub-pixel variants
                img = Image.new("L", (int(np.ceil(adv)) + 6,
                                      LINE_HEIGHT), 255)
                ImageDraw.Draw(img).text((fx, 0), ch, fill=0,
                                         font=self._font)
                t = (255.0 - np.asarray(img, np.float32)) / 255.0
                w = max(int(np.floor(adv)) + (1 if fx else 0), 2)
                stack, info = by_width.setdefault(w, ([], []))
                stack.append(np.ascontiguousarray(t[:, :w]))
                info.append((ch, int(round(adv))))
        self._by_width = {w: (np.stack(s), i)
                          for w, (s, i) in by_width.items()}
        self._max_w = max(self._by_width)

    # ------------------------------------------------------------------
    def _candidates(self, ink: np.ndarray, dys: List[int]):
        """Pruned match candidates for every line origin in ``dys``.

        Returns {dy: {x: [(char, advance, width, err), ...]}} computed
        from ONE sliding-window einsum per template width."""
        from numpy.lib.stride_tricks import sliding_window_view
        H, W = ink.shape
        need_h = max(dys) + LINE_HEIGHT
        pad = np.pad(ink, ((0, max(0, need_h - H)), (0, self._max_w)))
        out: Dict[int, Dict[int, list]] = {dy: {} for dy in dys}
        for w, (stack, info) in self._by_width.items():
            wins = sliding_window_view(pad, (LINE_HEIGHT, w))  # [DY, X, H, w]
            wins = wins[np.asarray(dys)][:, :W]
            w2 = (wins ** 2).sum((2, 3))                       # [DY, X]
            t2 = (stack ** 2).sum((1, 2))                      # [T]
            cross = np.einsum("dxhw,thw->tdx", wins, stack)
            err = w2[None] + t2[:, None, None] - 2.0 * cross   # [T, DY, X]
            keep = err < (PRUNE_FRAC * t2[:, None, None] + PRUNE_ABS)
            for ti, di, x in np.argwhere(keep):
                ch, adv = info[ti]
                out[dys[di]].setdefault(int(x), []).append(
                    (ch, adv, w, float(err[ti, di, x])))
        return out

    def _decode_line(self, col_ink: np.ndarray,
                     cands: Dict[int, list]) -> Tuple[float, str]:
        """Viterbi over columns for one aligned line."""
        W = len(col_ink)
        cum = np.concatenate([[0.0], np.cumsum(col_ink)])
        INF = float("inf")
        dp = np.full(W + 1, INF)
        dp[0] = 0.0
        back: List[Tuple[int, Optional[str], int]] = [(-1, None, 0)] * (W + 1)
        for x in range(W):
            if dp[x] == INF:
                continue
            c = dp[x] + col_ink[x] + SKIP_BASE
            if c < dp[x + 1]:
                dp[x + 1] = c
                back[x + 1] = (x, None, 0)
            for ch, adv, w, err in cands.get(x, ()):
                base = err + GLYPH_COST
                for slack in (0, -1, 1):
                    nx = x + adv + slack
                    if not 0 < nx <= W:
                        continue
                    cost = base + (SLACK_COST if slack else 0.0)
                    if nx > x + w:  # pay for columns the window skipped
                        cost += cum[nx] - cum[x + w]
                    if dp[x] + cost < dp[nx]:
                        dp[nx] = dp[x] + cost
                        back[nx] = (x, ch, adv)
        x, parts = W, []
        while x > 0:
            px, ch, adv = back[x]
            if ch is not None:
                parts.append((px, adv, ch))
            x = px
        parts.reverse()
        out: List[str] = []
        for i, (x0, adv, ch) in enumerate(parts):
            if i:
                px0, padv, _ = parts[i - 1]
                if x0 - (px0 + padv) >= SPACE_GAP:
                    out.append(" ")
            out.append(ch)
        return float(dp[W]), "".join(out).strip()

    # ------------------------------------------------------------------
    def decode(self, image) -> str:
        """OCR one single-line text crop (ndarray HxW[x3] uint8 or PIL)."""
        ink = _to_ink(image)
        if ink is None:
            return ""
        ink = _mask_rule_lines(ink)
        rows = np.where(ink.max(1) > 0.25)[0]
        if len(rows) == 0:
            return ""
        # candidate line origins span the WHOLE ink row range, not just the
        # topmost ink row: a crop dilated into a neighboring axis line (the
        # extract flow dilates boxes 5px, detector/ocr.py) has ink rows
        # starting well above the glyphs, and anchoring only to rows[0]
        # would never try the text's true origin
        lo = max(0, int(rows[0]) - (LINE_HEIGHT - 3))
        hi = min(int(rows[-1]) + 1, ink.shape[0])
        dys = list(range(lo, hi))
        if len(dys) > 48:       # bound the einsum DY axis on tall crops
            dys = dys[:48]
        cands = self._candidates(ink, dys)
        need_h = max(dys) + LINE_HEIGHT
        pad = np.pad(ink, ((0, max(0, need_h - ink.shape[0])), (0, 0)))
        # ink OUTSIDE a dy's window is unexplained by construction — charge
        # it to that dy so a window over blank rows can't undercut the one
        # actually covering the glyphs (calibrates costs across dys)
        total_ink = float((pad ** 2).sum())
        best = (float("inf"), "")
        for dy in dys:
            col_ink = (pad[dy:dy + LINE_HEIGHT] ** 2).sum(0)
            c, s = self._decode_line(col_ink, cands[dy])
            c += total_ink - float(col_ink.sum())
            if c < best[0]:
                best = (c, s)
        return best[1]


def _mask_rule_lines(ink: np.ndarray) -> np.ndarray:
    """Zero out foreign ink that box dilation pulled into the crop.

    The extract flow dilates every text box 5px before OCR
    (detector/ocr.py), so tick crops often contain a slice of the chart's
    axis rule or a neighboring element. That ink would otherwise be
    'explained' by phantom glyphs (skipping ink costs its full energy, so
    hallucinating a glyph over a rule is cheaper by construction).

    The dilation margin gives a clean invariant: the box surrounds the
    text, so genuine glyph ink is interior — any connected ink component
    touching the crop border came from OUTSIDE the text box. Remove
    those; if that would drop (nearly) all ink the crop was clamped at an
    image edge and the text itself touches the border — keep the
    original ink in that case."""
    on = ink > 0.25
    if not on.any():
        return ink
    from scipy import ndimage
    labels, n = ndimage.label(on)
    border = np.unique(np.concatenate([
        labels[0], labels[-1], labels[:, 0], labels[:, -1]]))
    border = border[border != 0]
    if len(border) == 0:
        return ink
    foreign = np.isin(labels, border)
    kept = float(ink[~foreign].sum())
    if kept < 0.25 * float(ink.sum()):
        return ink
    out = ink.copy()
    out[foreign] = 0.0
    return out


def _to_ink(image) -> Optional[np.ndarray]:
    """Any crop -> [H, W] ink intensity in 0..1 (dark-on-light assumed)."""
    a = np.asarray(image)
    if a.size == 0:
        return None
    if a.ndim == 3:
        a = a[..., :3].mean(-1)
    a = a.astype(np.float32)
    if a.max() > 1.5:       # 0..255 input
        a = a / 255.0
    return 1.0 - a


def image_to_string(image) -> str:
    """pytesseract-compatible entry point (module-level, lazily built)."""
    global _ENGINE
    if _ENGINE is None:
        _ENGINE = TemplateOCR()
    return _ENGINE.decode(image)
