# -*- coding: utf-8 -*-
"""Common Voice preprocessing: raw TSV/audio dumps -> 16 kHz WAVs + manifests.

    python -m fddm_asr_tpu_torch.scripts.preprocess --auto_merge --splits train,dev,test

Counterpart of `scripts/preprocess.py`, with its flags (--auto_merge,
--dataset_names/--dataset_name, --language, --splits, --batch_size,
--text_similarity_threshold, --enable_audio_hash, --use_memory_optimized)
and its artifacts, relative to the working directory:

  data/processed/{split}.json / .csv   records {path, sentence, text, duration,
                                       processed_path, language, dataset, split,
                                       audio_hash}
  data/processed/clips/*.wav           16 kHz mono PCM16
  data/processed/merge_report.json
  data/processed/duplicates_removed.json

from `data/raw/<dataset>/<language>/{clips/, <split>.tsv}`.  The TSV is
read tolerantly (dev.tsv | validation.tsv | validated.tsv; a `filename`
column for `path`, `text` for `sentence`); texts go through
`data.text.normalize_text`; clips outside 0.1-30 s are dropped; exact and
near-duplicate texts (and, with --enable_audio_hash, identical converted
audio) are removed.  Near duplicates are found through `DedupIndex`: a
length band and a character-multiset bound prune the candidates before
difflib confirms, so each text meets only those that could reach the
threshold.  Records are flushed in chunks to temporary files and merged
into the manifests at the end.

The TSV is read with the standard csv module (no pandas; quotes are
literal, as in the JAX script's `quoting=3`): a row missing its last
fields reads them as empty, where pandas reads the text "nan".  MP3 clips
are decoded by the port's `data/mp3.py`, so no ffmpeg is needed.
"""
from __future__ import annotations

import argparse
import csv
import datetime
import hashlib
import json
import os
from collections import Counter, defaultdict
from difflib import SequenceMatcher
from typing import Dict, List, Optional, Set, Tuple

from fddm_asr_tpu_torch.data.audio_io import to_wav_16k_mono
from fddm_asr_tpu_torch.data.text import normalize_text

__all__ = ["DedupIndex", "read_split_tsv", "build_manifests_auto_merge", "main"]

RAW_DIR = os.path.join("data", "raw")
PROCESSED_DIR = os.path.join("data", "processed")
CLIPS_DIR = os.path.join(PROCESSED_DIR, "clips")

MIN_DURATION, MAX_DURATION = 0.1, 30.0

_SPLIT_TSVS = {
    "train": ["train.tsv"],
    "dev": ["dev.tsv", "validation.tsv", "validated.tsv"],
    "test": ["test.tsv"],
    "validated": ["validated.tsv"],
    "other": ["other.tsv"],
}


# ------------------------------------------------------------- discovery
def detect_languages(cv_root: str) -> List[str]:
    """Languages: the subdirectories that hold a clips/ folder."""
    if not os.path.isdir(cv_root):
        return []
    return sorted(d for d in os.listdir(cv_root)
                  if os.path.isdir(os.path.join(cv_root, d, "clips")))


def detect_datasets(dataset_names: Optional[List[str]] = None) -> List[str]:
    """Datasets: the subdirectories of data/raw/ with a language in them."""
    if not os.path.isdir(RAW_DIR):
        return []
    return [name for name in sorted(os.listdir(RAW_DIR))
            if os.path.isdir(os.path.join(RAW_DIR, name))
            and (not dataset_names or name in dataset_names)
            and detect_languages(os.path.join(RAW_DIR, name))]


def read_split_tsv(cv_lang_dir: str, split_name: str) -> List[Tuple[str, str]]:
    """(path, sentence) rows of a split's TSV (module docstring)."""
    tsv_path = next((os.path.join(cv_lang_dir, fn)
                     for fn in _SPLIT_TSVS.get(split_name, [f"{split_name}.tsv"])
                     if os.path.isfile(os.path.join(cv_lang_dir, fn))), None)
    if tsv_path is None:
        raise FileNotFoundError(f"no TSV for split {split_name} under {cv_lang_dir}")
    with open(tsv_path, "r", encoding="utf-8-sig", newline="") as f:
        rows = [r for r in csv.reader(f, delimiter="\t", quoting=csv.QUOTE_NONE) if r]
    header = rows[0] if rows else []
    col = {}
    for want, alias in (("path", "filename"), ("sentence", "text")):
        if want in header:
            col[want] = header.index(want)
        elif alias in header:
            col[want] = header.index(alias)
        else:
            raise KeyError(f"{tsv_path} lacks a '{want}' column: {header}")
    return [tuple(r[col[k]] if col[k] < len(r) else "" for k in ("path", "sentence"))
            for r in rows[1:]]


# ----------------------------------------------------------------- dedup
def calculate_audio_hash(file_path: str) -> Optional[str]:
    try:
        h = hashlib.md5()
        with open(file_path, "rb") as f:
            for chunk in iter(lambda: f.read(65536), b""):
                h.update(chunk)
        return h.hexdigest()
    except OSError:
        return None


def text_similarity(a: str, b: str) -> float:
    return SequenceMatcher(None, a, b).ratio()


class DedupIndex:
    """Exact and near-duplicate text index, length-bucketed.

    difflib's ratio is 2 M / (len(a) + len(b)) with M the matched
    characters, and M is at most the multiset intersection of the two
    texts' characters: candidates whose length or histogram cannot reach
    the threshold are skipped before any quadratic match."""

    def __init__(self, threshold: float = 0.95):
        self.threshold = threshold
        self.exact: Set[str] = set()
        self.by_length: Dict[int, List[Tuple[str, Counter]]] = defaultdict(list)

    def add(self, text: str) -> None:
        self.exact.add(text)
        self.by_length[len(text)].append((text, Counter(text)))

    def check(self, text: str) -> Tuple[bool, str]:
        if text in self.exact:
            return True, "exact text match"
        if self.threshold < 1.0 and len(text) > 0:
            n = len(text)
            hist = Counter(text)
            # the length band: ratio <= 2 min(a, b) / (a + b)
            lo = max(1, int(n * self.threshold / (2 - self.threshold)) - 1)
            hi = int(n * (2 - self.threshold) / self.threshold) + 2
            for m in range(lo, hi):
                for cand, cand_hist in self.by_length.get(m, ()):
                    inter = sum((hist & cand_hist).values())
                    if 2.0 * inter / (n + m) < self.threshold:
                        continue
                    if text_similarity(text, cand) >= self.threshold:
                        return True, f"similar text (>= {self.threshold})"
        return False, ""


# ------------------------------------------------------------ processing
def _duplicate(stats: Dict, text: str, path: str, dataset: str, lang: str, split: str,
               reason: str) -> None:
    stats["global_stats"]["duplicates_removed"] += 1
    stats["global_stats"]["duplicates_detail"].append({
        "text": text, "path": path, "dataset": dataset, "language": lang, "split": split,
        "reason": reason})


def process_language_batch(dataset_name: str, lang: str, splits: List[str], batch_size: int,
                           dedup: DedupIndex, seen_audio_hashes: Set[str],
                           enable_audio_hash: bool, stats: Dict) -> float:
    """Convert, filter and deduplicate one dataset's language; returns the
    seconds of audio kept."""
    cv_lang_dir = os.path.join(RAW_DIR, dataset_name, lang)
    clips_dir = os.path.join(cv_lang_dir, "clips")
    os.makedirs(CLIPS_DIR, exist_ok=True)
    total_duration = 0.0
    g = stats["global_stats"]
    for split in splits:
        try:
            rows = read_split_tsv(cv_lang_dir, split)
        except (FileNotFoundError, KeyError) as e:
            print(f"  skip {split}: {e}")
            continue
        records = []
        split_stats = stats["split_stats"][split]
        for path, sentence in rows:
            g["total_found"] += 1
            text = normalize_text(sentence)
            if not text:
                g["invalid_files"] += 1
                continue
            dup, reason = dedup.check(text)
            if dup:
                _duplicate(stats, text, path, dataset_name, lang, split, reason)
                continue
            base = os.path.splitext(os.path.basename(path))[0]
            dst = os.path.join(CLIPS_DIR, f"{dataset_name}_{lang}_{base}.wav")
            duration = to_wav_16k_mono(os.path.join(clips_dir, path), dst)
            if duration < 0 or not MIN_DURATION <= duration <= MAX_DURATION:
                g["invalid_files"] += 1
                if os.path.exists(dst) and duration >= 0:
                    os.remove(dst)
                continue
            audio_hash = None
            if enable_audio_hash:
                audio_hash = calculate_audio_hash(dst)
                if audio_hash and audio_hash in seen_audio_hashes:
                    _duplicate(stats, text, path, dataset_name, lang, split,
                               "identical audio hash")
                    os.remove(dst)
                    continue
                if audio_hash:
                    seen_audio_hashes.add(audio_hash)
            dedup.add(text)
            rec = {"path": path, "sentence": sentence, "text": text, "duration": duration,
                   "processed_path": dst, "language": lang, "dataset": dataset_name,
                   "split": split, "audio_hash": audio_hash}
            records.append(rec)
            split_stats["records"].append(rec)
            split_stats["total_duration"] += duration
            total_duration += duration
            g["total_processed"] += 1
            if len(records) >= batch_size:
                _flush_temp(stats["flushes"], split, dataset_name, lang, records)
                records = []
        if records:
            _flush_temp(stats["flushes"], split, dataset_name, lang, records)
    return total_duration


def _flush_temp(counters: Dict[str, int], split: str, dataset: str, lang: str,
                records: List[Dict]) -> None:
    """Each flush writes a new chunk file (never a read-modify-write), named
    by a zero-padded counter (`counters`, by split, dataset and language)
    so the merge's sorted order is the records'."""
    key = f"{split}_{dataset}_{lang}"
    n = counters.get(key, 0)
    counters[key] = n + 1
    os.makedirs(PROCESSED_DIR, exist_ok=True)
    with open(os.path.join(PROCESSED_DIR, f"_tmp_{key}_{n:06d}.json"), "w",
              encoding="utf-8") as f:
        json.dump(records, f, ensure_ascii=False)


def _temps(split: str) -> List[str]:
    return [os.path.join(PROCESSED_DIR, name) for name in sorted(os.listdir(PROCESSED_DIR))
            if name.startswith(f"_tmp_{split}_") and name.endswith(".json")]


def clear_stale_temps(splits: List[str]) -> None:
    """Remove the temporary chunks a crashed earlier run left, which a
    merge would otherwise sweep into the fresh manifests."""
    if not os.path.isdir(PROCESSED_DIR):
        return
    for split in splits:
        for path in _temps(split):
            print(f"  removing stale temp from a previous run: {path}")
            os.remove(path)


def merge_temp_files_to_unified(splits: List[str]) -> None:
    """Concatenate each split's chunks into {split}.json/.csv, then delete them."""
    for split in splits:
        merged = []
        for path in _temps(split):
            with open(path, encoding="utf-8") as f:
                merged.extend(json.load(f))
            os.remove(path)
        if not merged:
            continue
        jpath = os.path.join(PROCESSED_DIR, f"{split}.json")
        with open(jpath, "w", encoding="utf-8") as f:
            json.dump(merged, f, ensure_ascii=False, indent=1)
        with open(os.path.join(PROCESSED_DIR, f"{split}.csv"), "w", newline="",
                  encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=list(merged[0].keys()))
            w.writeheader()
            w.writerows(merged)
        print(f"  wrote {jpath} ({len(merged)} records)")


def generate_merge_report(stats: Dict) -> None:
    g = stats["global_stats"]
    report = {
        "merge_summary": {
            "total_datasets": stats["total_datasets"],
            "total_languages": len(stats["languages_processed"]),
            "datasets_processed": stats["datasets_processed"],
            "languages_processed": sorted(stats["languages_processed"]),
            "total_duration_hours": stats["total_duration"] / 3600.0,
            "processing_timestamp": datetime.datetime.now().isoformat(),
        },
        "global_statistics": g,
        "split_statistics": {
            split: {"total_records": len(d["records"]),
                    "total_duration_hours": d["total_duration"] / 3600.0,
                    "avg_duration_seconds": (d["total_duration"] / len(d["records"])
                                             if d["records"] else 0)}
            for split, d in stats["split_stats"].items() if d["records"]},
        "duplicates_detail": g["duplicates_detail"],
    }
    os.makedirs(PROCESSED_DIR, exist_ok=True)
    with open(os.path.join(PROCESSED_DIR, "merge_report.json"), "w", encoding="utf-8") as f:
        json.dump(report, f, ensure_ascii=False, indent=2)
    if g["duplicates_detail"]:
        with open(os.path.join(PROCESSED_DIR, "duplicates_removed.json"), "w",
                  encoding="utf-8") as f:
            json.dump(g["duplicates_detail"], f, ensure_ascii=False, indent=2)
    print(f"\ndatasets={stats['total_datasets']} languages={len(stats['languages_processed'])} "
          f"hours={stats['total_duration'] / 3600.0:.2f} found={g['total_found']} "
          f"processed={g['total_processed']} dupes={g['duplicates_removed']} "
          f"invalid={g['invalid_files']}")


def build_manifests_auto_merge(dataset_names: Optional[List[str]], language: Optional[str],
                               splits: List[str], batch_size: int,
                               text_similarity_threshold: float,
                               enable_audio_hash: bool) -> Dict:
    dedup = DedupIndex(text_similarity_threshold)
    seen_audio_hashes: Set[str] = set()
    stats: Dict = {
        "total_duration": 0.0, "total_datasets": 0, "datasets_processed": [],
        "languages_processed": set(),
        "split_stats": {s: {"records": [], "total_duration": 0.0} for s in splits},
        "global_stats": {"total_found": 0, "total_processed": 0, "duplicates_removed": 0,
                         "invalid_files": 0, "duplicates_detail": []},
        "flushes": {},
    }
    clear_stale_temps(splits)
    datasets = detect_datasets(dataset_names)
    if not datasets:
        raise ValueError(f"no datasets found under {RAW_DIR}")
    print(f"datasets: {datasets}")
    stats["total_datasets"] = len(datasets)
    for dataset_name in datasets:
        langs = [language] if language else detect_languages(os.path.join(RAW_DIR, dataset_name))
        stats["languages_processed"].update(langs)
        for lang in langs:
            try:
                print(f"processing {dataset_name}/{lang}")
                stats["total_duration"] += process_language_batch(
                    dataset_name, lang, splits, batch_size, dedup, seen_audio_hashes,
                    enable_audio_hash, stats)
            except Exception as e:  # one language's failure leaves the others
                print(f"  error in {lang}: {e}")
        stats["datasets_processed"].append(dataset_name)
    merge_temp_files_to_unified(splits)
    generate_merge_report(stats)
    return stats


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Convert local Common Voice dumps to 16 kHz WAV + manifests "
                    "(multi-version auto-merge supported)")
    p.add_argument("--dataset_names", type=str, default="")
    p.add_argument("--dataset_name", type=str, default="")
    p.add_argument("--language", type=str, default="")
    p.add_argument("--splits", type=str, default="train,dev,test")
    p.add_argument("--batch_size", type=int, default=1000)
    p.add_argument("--text_similarity_threshold", type=float, default=0.95)
    p.add_argument("--enable_audio_hash", action="store_true")
    p.add_argument("--auto_merge", action="store_true")
    p.add_argument("--use_memory_optimized", action="store_true",
                   help="accepted for CLI compatibility; streaming is always on")
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    splits = [s.strip() for s in args.splits.split(",") if s.strip()]
    dataset_names = None
    if args.dataset_names:
        dataset_names = [n.strip() for n in args.dataset_names.split(",") if n.strip()]
    elif args.dataset_name:
        dataset_names = [args.dataset_name]
    return build_manifests_auto_merge(
        dataset_names=dataset_names, language=args.language or None, splits=splits,
        batch_size=args.batch_size, text_similarity_threshold=args.text_similarity_threshold,
        enable_audio_hash=args.enable_audio_hash)


if __name__ == "__main__":
    main()
