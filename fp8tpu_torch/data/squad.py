"""SQuAD v1.1/v2 loading + feature conversion for the BERT QA examples: a
copy of the JAX package's ``fp8tpu/data/squad.py`` (pure Python and NumPy),
which gives the same features, arrays and metrics.

The reference's run_squad.py delegates to HF's
``squad_convert_examples_to_features`` (run_squad.py:699-706) with
max_seq_length=384, doc_stride=128, max_query_length=64; this module
reimplements that pipeline natively: JSON parsing, a local-vocab
WordPiece tokenizer (point ``vocab_file`` at any BERT vocab.txt),
whitespace -> subtoken offset maps, and the sliding doc-span windows,
emitting the {input_ids, attention_mask, token_type_ids, start, end}
arrays that ``fp8tpu_torch.examples.bert_squad_ptq`` and
``bert_qa_finetune`` consume via ``--data_npz``.

No dataset or vocab ships with the repo; both are standard local files
for anyone running the real benchmark.
"""

from __future__ import annotations

import json
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


# -- WordPiece (local vocab.txt, BERT semantics) --------------------------

def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    """BERT basic+wordpiece tokenization from a local vocab file:
    lowercase/strip accents (uncased), split on whitespace and
    punctuation, then greedy longest-match subwords with '##'
    continuations; OOV → [UNK]."""

    def __init__(self, vocab_file: str, lowercase: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab: Dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.lowercase = lowercase
        self.max_chars = max_chars_per_word
        for tok in ("[UNK]", "[CLS]", "[SEP]", "[PAD]"):
            if tok not in self.vocab:
                raise ValueError(f"vocab is missing {tok}")

    def basic_tokenize(self, text: str) -> List[str]:
        if self.lowercase:
            text = unicodedata.normalize("NFD", text.lower())
            text = "".join(c for c in text
                           if unicodedata.category(c) != "Mn")
        out: List[str] = []
        word = ""
        for ch in text:
            if ch.isspace():
                if word:
                    out.append(word)
                word = ""
            elif _is_punct(ch):
                if word:
                    out.append(word)
                word = ""
                out.append(ch)
            else:
                word += ch
        if word:
            out.append(word)
        return out

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return ["[UNK]"]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return ["[UNK]"]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        return [p for w in self.basic_tokenize(text)
                for p in self.wordpiece(w)]

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        unk = self.vocab["[UNK]"]
        return [self.vocab.get(t, unk) for t in tokens]


# -- SQuAD JSON → examples -------------------------------------------------

@dataclass
class SquadExample:
    qid: str
    question: str
    doc_tokens: List[str]              # whitespace tokens of the context
    answer_text: str = ""
    start_token: int = -1              # answer span in doc_tokens
    end_token: int = -1
    is_impossible: bool = False
    # ALL gold answer strings (dev questions carry several; the official
    # metric takes the max over them).  Populated regardless of
    # is_training — is_training only gates the char→token span maps.
    all_answers: List[str] = None


def parse_squad_json(path: str, is_training: bool = True
                     ) -> List[SquadExample]:
    """SQuAD v1.1/v2.0 JSON → examples with whitespace doc tokens and the
    answer mapped from char offsets to token indices (the v2
    ``is_impossible`` flag carries through)."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)["data"]
    examples = []
    for article in data:
        for para in article["paragraphs"]:
            context = para["context"]
            doc_tokens: List[str] = []
            char_to_word: List[int] = []
            prev_ws = True
            for ch in context:
                if ch.isspace():
                    prev_ws = True
                else:
                    if prev_ws:
                        doc_tokens.append(ch)
                    else:
                        doc_tokens[-1] += ch
                    prev_ws = False
                char_to_word.append(len(doc_tokens) - 1)
            for qa in para["qas"]:
                ex = SquadExample(qid=qa["id"], question=qa["question"],
                                  doc_tokens=doc_tokens,
                                  is_impossible=qa.get("is_impossible",
                                                       False))
                if qa.get("answers") and not ex.is_impossible:
                    ex.all_answers = [a["text"] for a in qa["answers"]]
                    ans = qa["answers"][0]
                    ex.answer_text = ans["text"]
                    if is_training:
                        s = ans["answer_start"]
                        e = s + len(ans["text"]) - 1
                        if (0 <= s < len(char_to_word)
                                and e < len(char_to_word)):
                            ex.start_token = char_to_word[s]
                            ex.end_token = char_to_word[e]
                examples.append(ex)
    return examples


# -- examples → model features (sliding doc spans) -------------------------

@dataclass
class SquadFeatures:
    input_ids: np.ndarray          # (N, L) int32
    attention_mask: np.ndarray     # (N, L) int32
    token_type_ids: np.ndarray     # (N, L) int32
    start: np.ndarray              # (N,) int32 — 0 ([CLS]) if not in span
    end: np.ndarray                # (N,) int32
    example_index: np.ndarray      # (N,) int32 — feature → example
    token_to_orig: List[Dict[int, int]] = field(default_factory=list)
    doc_span_start: Optional[np.ndarray] = None


def _improve_answer_span(all_doc_tokens, start, end, tokenizer,
                         orig_answer_text):
    """Shrink a whitespace-token answer span onto the exact subtoken run
    that re-tokenizes to the answer (HF's _improve_answer_span rule)."""
    tok_answer = " ".join(tokenizer.tokenize(orig_answer_text))
    for new_start in range(start, end + 1):
        for new_end in range(end, new_start - 1, -1):
            span = " ".join(all_doc_tokens[new_start:new_end + 1])
            if span == tok_answer:
                return new_start, new_end
    return start, end


def convert_examples_to_features(
    examples: List[SquadExample],
    tokenizer: WordPieceTokenizer,
    max_seq_length: int = 384,
    doc_stride: int = 128,
    max_query_length: int = 64,
    is_training: bool = True,
) -> SquadFeatures:
    """The reference pipeline's feature conversion
    (squad_convert_examples_to_features semantics): [CLS] query [SEP]
    doc-chunk [SEP] windows sliding by ``doc_stride``; training windows
    that do not fully contain the answer point start=end=0 ([CLS])."""
    cls_id = tokenizer.vocab["[CLS]"]
    sep_id = tokenizer.vocab["[SEP]"]
    pad_id = tokenizer.vocab["[PAD]"]

    rows_ids, rows_mask, rows_type = [], [], []
    rows_start, rows_end, rows_exidx = [], [], []
    tok_maps: List[Dict[int, int]] = []
    span_starts = []

    for ex_index, ex in enumerate(examples):
        query_ids = tokenizer.convert_tokens_to_ids(
            tokenizer.tokenize(ex.question))[:max_query_length]

        tok_to_orig: List[int] = []
        orig_to_tok: List[int] = []
        all_doc_ids: List[int] = []
        for i, w in enumerate(ex.doc_tokens):
            orig_to_tok.append(len(all_doc_ids))
            for piece in tokenizer.tokenize(w):
                tok_to_orig.append(i)
                all_doc_ids.append(tokenizer.convert_tokens_to_ids(
                    [piece])[0])

        tok_start = tok_end = -1
        if is_training and ex.start_token >= 0:
            tok_start = orig_to_tok[ex.start_token]
            tok_end = (orig_to_tok[ex.end_token + 1] - 1
                       if ex.end_token + 1 < len(ex.doc_tokens)
                       else len(all_doc_ids) - 1)
            sub_tokens = [tokenizer.inv_vocab[t] for t in all_doc_ids]
            tok_start, tok_end = _improve_answer_span(
                sub_tokens, tok_start, tok_end, tokenizer, ex.answer_text)

        max_doc = max_seq_length - len(query_ids) - 3
        spans: List[Tuple[int, int]] = []
        offset = 0
        while True:
            length = min(max_doc, len(all_doc_ids) - offset)
            spans.append((offset, length))
            if offset + length >= len(all_doc_ids):
                break
            offset += min(length, doc_stride)

        for span_off, span_len in spans:
            ids = ([cls_id] + query_ids + [sep_id]
                   + all_doc_ids[span_off:span_off + span_len] + [sep_id])
            type_ids = [0] * (len(query_ids) + 2) + [1] * (span_len + 1)
            mask = [1] * len(ids)
            doc_base = len(query_ids) + 2
            tmap = {doc_base + k: tok_to_orig[span_off + k]
                    for k in range(span_len)}

            start = end = 0
            if is_training and tok_start >= 0:
                if span_off <= tok_start and tok_end < span_off + span_len:
                    start = doc_base + (tok_start - span_off)
                    end = doc_base + (tok_end - span_off)
            pad = max_seq_length - len(ids)
            rows_ids.append(ids + [pad_id] * pad)
            rows_mask.append(mask + [0] * pad)
            rows_type.append(type_ids + [0] * pad)
            rows_start.append(start)
            rows_end.append(end)
            rows_exidx.append(ex_index)
            tok_maps.append(tmap)
            span_starts.append(span_off)

    return SquadFeatures(
        input_ids=np.asarray(rows_ids, np.int32),
        attention_mask=np.asarray(rows_mask, np.int32),
        token_type_ids=np.asarray(rows_type, np.int32),
        start=np.asarray(rows_start, np.int32),
        end=np.asarray(rows_end, np.int32),
        example_index=np.asarray(rows_exidx, np.int32),
        token_to_orig=tok_maps,
        doc_span_start=np.asarray(span_starts, np.int32),
    )


# -- answer decoding + official-normalization metrics ----------------------

def _normalize_answer(s: str) -> str:
    """SQuAD's official normalization: lowercase, drop punctuation,
    articles (a/an/the) and extra whitespace (evaluate-v1.1.py rule)."""
    s = "".join(ch for ch in s.lower() if not _is_punct(ch))
    toks = [t for t in s.split() if t not in ("a", "an", "the")]
    return " ".join(toks)


def decode_answers(features: SquadFeatures,
                   examples: List[SquadExample],
                   start_logits: np.ndarray, end_logits: np.ndarray,
                   max_answer_len: int = 30,
                   null_threshold: Optional[float] = None
                   ) -> Dict[str, str]:
    """Per-example best answer STRING from per-feature span logits.

    The reference's write_predictions flow (run_squad.py → HF
    compute_predictions_logits): for every feature, score doc-token
    spans by start+end logit sum (positions outside the doc chunk are
    masked), pick the best span across all of an example's windows, and
    map it back to the original whitespace tokens.  Returns {qid: text}.

    ``null_threshold`` enables the v2 (version_2_with_negative) rule:
    the null score is the [CLS] start+end logit sum (min over the
    example's windows); predict "" when
    ``null_score - best_non_null > null_threshold``.
    """
    sl = np.asarray(start_logits)
    el = np.asarray(end_logits)
    best: Dict[int, Tuple[float, str]] = {}
    null_score: Dict[int, float] = {}
    for fi in range(sl.shape[0]):
        tmap = features.token_to_orig[fi]
        if not tmap:
            continue
        ex_i = int(features.example_index[fi])
        ns = float(sl[fi, 0] + el[fi, 0])          # [CLS] span score
        null_score[ex_i] = min(null_score.get(ex_i, np.inf), ns)
        doc_pos = sorted(tmap)
        lo, hi = doc_pos[0], doc_pos[-1]
        s_view = sl[fi, lo:hi + 1]
        e_view = el[fi, lo:hi + 1]
        n = hi - lo + 1
        score_best, s_best, e_best = -np.inf, 0, 0
        order = np.argsort(s_view)[::-1][:20]
        for s_i in order:
            e_cap = min(n, s_i + max_answer_len)
            e_i = s_i + int(np.argmax(e_view[s_i:e_cap]))
            sc = float(s_view[s_i] + e_view[e_i])
            if sc > score_best:
                score_best, s_best, e_best = sc, int(s_i), int(e_i)
        ex = examples[ex_i]
        w0, w1 = tmap[lo + s_best], tmap[lo + e_best]
        text = " ".join(ex.doc_tokens[w0:w1 + 1])
        if ex_i not in best or score_best > best[ex_i][0]:
            best[ex_i] = (score_best, text)
    out = {}
    for i, (score, text) in best.items():
        if (null_threshold is not None
                and null_score.get(i, np.inf) - score > null_threshold):
            text = ""
        out[examples[i].qid] = text
    return out


def _f1_score(pred: str, gold: str) -> float:
    pt, gt = pred.split(), gold.split()
    if not pt or not gt:
        return float(pt == gt)
    common: Dict[str, int] = {}
    for t in pt:
        common[t] = common.get(t, 0) + 1
    overlap = sum(min(c, gt.count(t)) for t, c in common.items())
    if not overlap:
        return 0.0
    prec, rec = overlap / len(pt), overlap / len(gt)
    return 2 * prec * rec / (prec + rec)


def squad_string_em_f1(predictions: Dict[str, str],
                       examples: List[SquadExample]) -> Dict[str, float]:
    """Official string-level EM / token-overlap F1 (evaluate-v1.1.py
    semantics: metric_max_over_ground_truths over ALL gold answers) over
    {qid: predicted text}."""
    em = f1 = n = 0
    for ex in examples:
        n += 1
        pred = _normalize_answer(predictions.get(ex.qid, ""))
        golds = ex.all_answers or ([ex.answer_text] if ex.answer_text
                                   else [])
        if ex.is_impossible or not golds:
            # v2: an unanswerable question scores 1 iff predicted empty
            em += float(pred == "")
            f1 += float(pred == "")
            continue
        norm = [_normalize_answer(g) for g in golds]
        em += max(float(pred == g) for g in norm)
        f1 += max(_f1_score(pred, g) for g in norm)
    n = max(n, 1)
    return {"exact_match": 100.0 * em / n, "f1": 100.0 * f1 / n}


def squad_to_npz(json_path: str, vocab_file: str, out: str,
                 max_seq_length: int = 384, doc_stride: int = 128,
                 max_query_length: int = 64,
                 limit: Optional[int] = None) -> int:
    """SQuAD JSON + vocab → the ``--data_npz`` file the BERT QA examples
    consume ({input_ids, attention_mask, token_type_ids, start, end}).
    Returns the number of features written."""
    tokenizer = WordPieceTokenizer(vocab_file)
    examples = parse_squad_json(json_path)
    if limit is not None:
        examples = examples[:limit]
    f = convert_examples_to_features(
        examples, tokenizer, max_seq_length, doc_stride, max_query_length)
    np.savez(out, input_ids=f.input_ids, attention_mask=f.attention_mask,
             token_type_ids=f.token_type_ids, start=f.start, end=f.end,
             example_index=f.example_index)
    return int(f.input_ids.shape[0])
