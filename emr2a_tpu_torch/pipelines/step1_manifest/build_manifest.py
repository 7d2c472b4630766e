"""Step 1 — build the patient manifest from clinical CSVs + CT folders.

Port of ``emr2a_tpu/pipelines/step1_manifest/build_manifest.py``: the same
flags, the same multi-encoding CSV read (utf-8-sig, gb18030, gbk, utf-8),
the headerless fallback with the [name, sex, age, fever, symptom] schema,
the natural-sorted slice scan, the 4-stage CSV-to-folder matching
(patient_id, exact name, whitespace-normalised name, pinyin when
``pypinyin`` is installed), the SHA1 pseudo-IDs, the zh-header
canonicalisation of ``meta`` and the same four outputs: ``manifest.jsonl``,
``patient_mapping.csv``, ``missing_in_fs.csv`` and ``missing_in_csv.csv``,
byte for byte.

The JAX package's step1 reads and writes with pandas, which the card's machine
lacks; this one uses the ``csv`` module and reproduces what pandas does
there (``tests/test_torch_step1.py`` holds the outputs equal):

- reading (``read_csv(dtype=str, keep_default_na=False)``): blank and
  whitespace-only lines are skipped; an empty header cell is named
  ``Unnamed: {i}`` and a repeated one mangled (``name.1``); a short row is
  filled with empty strings. A row longer than the header raises
  ``ValueError`` (pandas raises a ``ParserError``, or takes the first
  column as an index when every row is one longer: not reproduced);
- combining (``pd.concat``): the columns are the union in order of first
  appearance, and a column missing from one CSV is NaN in its rows, so
  ``meta`` may hold NaN (``json.dumps`` writes ``NaN``) and a NaN name or
  id reads as missing, as ``pd.notna`` / ``str(nan)`` make it;
- writing (``to_csv(index=False, encoding="utf-8-sig")``): a BOM, minimal
  quoting, ``\\n`` line ends.

    python -m emr2a_tpu_torch.pipelines.step1_manifest.run \\
        --data_root data --out_dir outputs
"""

from __future__ import annotations

import argparse
import csv
import hashlib
import io
import json
import math
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

try:
    from pypinyin import lazy_pinyin as _lazy_pinyin  # type: ignore
    PINYIN_AVAILABLE = True
except Exception:
    _lazy_pinyin = None
    PINYIN_AVAILABLE = False

LABEL_DIR_MAP = {
    "Bacterial": "Bacterial",
    "Viral": "Viral",
    "PJP": "PJP",
    "Normal": "Normal",
}

META_KEY_CANON = {
    "姓名": "name", "性别": "sex", "年龄": "age",
    "发热": "fever", "发烧": "fever", "症状": "symptom",
}

CSV_LABEL_MAP = {
    "Bacterial.csv": "Bacterial",
    "Viral.csv": "Viral",
    "PJP.csv": "PJP",
    "Normal.csv": "Normal",
}

NAME_GUESS = ["name", "姓名", "患者姓名", "PatientName"]

HEADERLESS_SCHEMA = ["name", "sex", "age", "fever", "symptom"]

NAN = float("nan")


class Table:
    """Rows of a CSV as dicts over ``columns``: str values, NaN where a
    combined table's column was missing from a row's CSV."""

    def __init__(self, columns: List, rows: List[dict]):
        self.columns = columns
        self.rows = rows


def _notna(value) -> bool:
    """``pd.notna`` of one value."""
    return value is not None and not (isinstance(value, float) and math.isnan(value))


def natural_key(text: str) -> List[object]:
    """Numeric-aware sort key so slice_2 < slice_10."""
    return [int(tok) if tok.isdigit() else tok.lower()
            for tok in re.split(r"(\d+)", text)]


def _dedup_names(names: List[str]) -> List[str]:
    """pandas' mangling of repeated header names: name, name.1, name.2."""
    counts: Dict[str, int] = {}
    out = []
    for col in names:
        cur = counts.get(col, 0)
        while cur > 0:
            counts[col] = cur + 1
            col = f"{col}.{cur}"
            cur = counts.get(col, 0)
        out.append(col)
        counts[col] = cur + 1
    return out


def _parse_csv(text: str, header, path: Path) -> Table:
    rows = [r for r in csv.reader(io.StringIO(text, newline=""))
            if r and not (len(r) == 1 and r[0].strip(" \t") == "")]
    if header is None:
        if not rows:
            raise ValueError(f"No columns to parse from file {path}")
        columns: List = list(range(len(rows[0])))
    else:
        if not rows:
            raise ValueError(f"No columns to parse from file {path}")
        columns = _dedup_names([name if name != "" else f"Unnamed: {i}"
                                for i, name in enumerate(rows[0])])
        rows = rows[1:]
    table = []
    for n, row in enumerate(rows):
        if len(row) > len(columns):
            raise ValueError(f"Error tokenizing {path}: expected {len(columns)} "
                             f"fields in data row {n + 1}, saw {len(row)}")
        row = row + [""] * (len(columns) - len(row))
        table.append(dict(zip(columns, row)))
    return Table(columns, table)


def read_csv_with_fallback(path: Path, header="infer") -> Table:
    raw = Path(path).read_bytes()
    last_err = None
    for enc in ("utf-8-sig", "gb18030", "gbk", "utf-8"):
        try:
            text = raw.decode(enc)
        except UnicodeDecodeError as e:
            last_err = e
            continue
        return _parse_csv(text, header, path)
    raise ValueError(f"Failed to decode {path} with any known encoding") from last_err


def resolve_name_col(table: Table, name_col: Optional[str]) -> str:
    if name_col:
        if name_col not in table.columns:
            raise ValueError(
                f"Name column '{name_col}' not found. Columns: {list(table.columns)}")
        return name_col
    for guess in NAME_GUESS:
        if guess in table.columns:
            return guess
    raise ValueError(f"Name column not found. Columns: {list(table.columns)}")


def _set_column(table: Table, name: str, values: List) -> None:
    if name not in table.columns:
        table.columns.append(name)
    for row, value in zip(table.rows, values):
        row[name] = value


def _concat(tables: List[Table]) -> Table:
    """``pd.concat(..., ignore_index=True)``: the union of the columns in
    order of first appearance, NaN where a table lacks a column."""
    columns: List = []
    for t in tables:
        columns += [c for c in t.columns if c not in columns]
    rows = [{c: row.get(c, NAN) for c in columns} for t in tables for row in t.rows]
    return Table(columns, rows)


def _read_all_csvs(csv_dir: Path, label_col: Optional[str],
                   header="infer") -> Table:
    tables = []
    for csv_name, label in CSV_LABEL_MAP.items():
        t = read_csv_with_fallback(csv_dir / csv_name, header=header)
        if header is None:
            n = len(t.columns)
            names = (HEADERLESS_SCHEMA if n == len(HEADERLESS_SCHEMA)
                     else ["name"] + [f"col_{i}" for i in range(1, n)])
            t = Table(list(names), [dict(zip(names, r.values())) for r in t.rows])
        if label_col:
            if label_col not in t.columns:
                raise ValueError(
                    f"Label column '{label_col}' not found in {csv_name}. "
                    f"Columns: {list(t.columns)}")
            _set_column(t, "__label__", [str(r[label_col]) for r in t.rows])
        else:
            _set_column(t, "__label__", [label] * len(t.rows))
        tables.append(t)
    return _concat(tables)


def load_csvs(data_root: Path, name_col: Optional[str], id_col: str,
              label_col: Optional[str]) -> Tuple[Table, str, bool]:
    """Read the four class CSVs; retry headerless when no name column
    resolves."""
    csv_dir = data_root / "Case_csv"
    merged = _read_all_csvs(csv_dir, label_col)
    try:
        resolved = resolve_name_col(merged, name_col)
    except ValueError:
        merged = _read_all_csvs(csv_dir, label_col, header=None)
        resolved = "name"
        print("Headerless CSVs detected; columns set to "
              "[name/sex/age/fever/symptom].")
    return merged, resolved, id_col in merged.columns


def parse_slice_exts(raw: str) -> Optional[List[str]]:
    if raw.strip() == "":
        return None
    exts = []
    for ext in raw.split(","):
        ext = ext.strip().lower()
        if not ext:
            continue
        exts.append(ext if ext.startswith(".") else f".{ext}")
    return exts or None


def normalize_folder_key(value: str) -> str:
    value = value.strip().lower().replace("-", "_").replace(" ", "_")
    value = re.sub(r"__+", "_", value)
    return value.strip("_")


def normalize_person_name(value: str) -> str:
    # Strip whitespace + zero-width characters (ZWSP/ZWNJ/ZWJ/BOM).
    return re.sub(r"[\s\u200b\u200c\u200d\ufeff]+", "", value.strip())


def name_to_pinyin(name: str) -> Optional[str]:
    if not PINYIN_AVAILABLE or _lazy_pinyin is None:
        return None
    return normalize_folder_key("_".join(_lazy_pinyin(name)))


def sha1_id(name: str) -> str:
    return "P" + hashlib.sha1(name.encode("utf-8")).hexdigest()[:10]


def scan_images(data_root: Path, slice_exts: Optional[List[str]],
                image_subdir: str, relative_paths: bool,
                relative_base: Path) -> Dict[str, Dict[str, List[str]]]:
    """{label: {patient_folder: [natural-sorted slice paths]}}."""
    image_root = data_root / image_subdir
    index: Dict[str, Dict[str, List[str]]] = {}
    for label, dir_name in LABEL_DIR_MAP.items():
        category_dir = image_root / dir_name
        patients: Dict[str, List[str]] = {}
        if category_dir.exists():
            for patient_dir in sorted(
                    (p for p in category_dir.iterdir() if p.is_dir()),
                    key=lambda p: p.name):
                files = [f for f in patient_dir.iterdir() if f.is_file()
                         and (not slice_exts or f.suffix.lower() in slice_exts)]
                files.sort(key=lambda p: natural_key(p.name))
                if relative_paths:
                    patients[patient_dir.name] = [
                        str(f.relative_to(relative_base)) for f in files]
                else:
                    patients[patient_dir.name] = [str(f) for f in files]
        index[label] = patients
    return index


def _row_patient_id(row: dict, id_col: str, has_id_col: bool, name: str) -> str:
    if has_id_col and _notna(row.get(id_col)):
        return str(row.get(id_col)).strip()
    return sha1_id(name)


def align(table: Table, name_col: str, id_col: str, has_id_col: bool,
          label_col: Optional[str],
          image_index: Dict[str, Dict[str, List[str]]],
          drop_name: bool, image_subdir: str
          ) -> Tuple[List[dict], Optional[List[dict]], List[dict], List[dict]]:
    """Match each CSV row to a patient slice folder; 4-stage matching:
    patient_id -> exact name -> whitespace-normalised name -> pinyin.
    Returns the manifest and the rows of the mapping (None when there is
    none), missing-in-FS and missing-in-CSV tables."""
    manifest: List[dict] = []
    missing_in_fs = []
    matched: Dict[str, set] = {label: set() for label in LABEL_DIR_MAP}
    mapping_rows = []

    image_index = {label: {k.strip(): v for k, v in patients.items()}
                   for label, patients in image_index.items()}
    normalized_index = {label: {normalize_person_name(k): k for k in patients}
                        for label, patients in image_index.items()}

    for row in table.rows:
        name = str(row.get(name_col, "")).strip()
        if not name or name == "nan":
            continue
        label = str(row.get(label_col, row.get("__label__", ""))).strip()
        if label not in image_index:
            continue

        label_patients = image_index[label]
        label_norm = normalized_index[label]

        folder_name = None
        match_by = None
        patient_id = None

        if has_id_col and _notna(row.get(id_col)):
            candidate = str(row.get(id_col)).strip()
            if candidate in label_patients:
                patient_id, match_by, folder_name = candidate, "patient_id", candidate
        if folder_name is None and name in label_patients:
            patient_id = _row_patient_id(row, id_col, has_id_col, name)
            match_by, folder_name = "name", name
        if folder_name is None:
            norm = normalize_person_name(name)
            if norm in label_norm:
                patient_id = _row_patient_id(row, id_col, has_id_col, name)
                match_by, folder_name = "name", label_norm[norm]
        if folder_name is None:
            pin = name_to_pinyin(name)
            if pin and pin in label_norm:
                patient_id = _row_patient_id(row, id_col, has_id_col, name)
                match_by, folder_name = "name", label_norm[pin]

        if folder_name is None:
            patient_id = _row_patient_id(row, id_col, has_id_col, name)
            match_by = "name"
            missing_in_fs.append({
                "patient_id": patient_id, "name": name, "label": label,
                "match_by": match_by,
                "expected_dir": str(Path(image_subdir) / LABEL_DIR_MAP[label] / name),
            })
            if not has_id_col:
                mapping_rows.append({
                    "patient_id": patient_id, "name": name, "label": label,
                    "folder_name": "", "match_by": match_by,
                })
            continue

        matched[label].add(folder_name)
        meta = dict(row)
        for key in [name_col, id_col, "__label__"]:
            meta.pop(key, None)
        if label_col:
            meta.pop(label_col, None)
        # known zh clinical columns under their English keys, which the
        # clinical-text rendering reads
        meta = {META_KEY_CANON.get(k, k): v for k, v in meta.items()}

        entry = {
            "patient_id": patient_id or sha1_id(name),
            "label": label,
            "image_dir": str(Path(image_subdir) / LABEL_DIR_MAP[label] / folder_name),
            "slices": label_patients.get(folder_name, []),
            "meta": meta,
            "match_by": match_by or "name",
        }
        if not drop_name:
            entry["name"] = name
        manifest.append(entry)

        if not has_id_col:
            mapping_rows.append({
                "patient_id": entry["patient_id"], "name": name, "label": label,
                "folder_name": folder_name, "match_by": match_by or "name",
            })

    missing_in_csv = [
        {"label": label, "folder_name": folder,
         "image_dir": str(Path(image_subdir) / LABEL_DIR_MAP[label] / folder)}
        for label, patients in image_index.items()
        for folder in patients if folder not in matched[label]
    ]
    return manifest, (mapping_rows or None), missing_in_fs, missing_in_csv


def write_manifest(out_dir: Path, manifest: List[dict]) -> None:
    with (out_dir / "manifest.jsonl").open("w", encoding="utf-8") as f:
        for row in manifest:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")


def write_table(path: Path, rows: List[dict]) -> None:
    """``pd.DataFrame(rows).to_csv(path, index=False, encoding="utf-8-sig")``:
    the keys in order of first appearance, a BOM, minimal quoting, ``\\n``
    line ends, NaN and missing keys as empty fields."""
    columns: List = []
    for row in rows:
        columns += [c for c in row if c not in columns]
    with open(path, "w", encoding="utf-8-sig", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for row in rows:
            writer.writerow(["" if not _notna(row.get(c)) else row[c]
                             for c in columns])


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Build manifest from CSV + CT image folders.")
    parser.add_argument("--data_root", default="data")
    parser.add_argument("--out_dir", "--output_dir", dest="out_dir",
                        default="outputs")
    parser.add_argument("--name_col", default=None)
    parser.add_argument("--id_col", default="patient_id")
    parser.add_argument("--label_col", default=None)
    parser.add_argument("--image_subdir", default="CT_2D_image_core")
    parser.add_argument("--relative_paths", default="true",
                        choices=["true", "false"])
    parser.add_argument("--slice_ext", default=".png,.jpg,.jpeg,.dcm")
    parser.add_argument("--drop_name", action="store_true")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    if not PINYIN_AVAILABLE:
        print("pypinyin not installed; name->pinyin folder matching disabled.")

    data_root = Path(args.data_root)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    table, name_col, has_id_col = load_csvs(
        data_root, args.name_col, args.id_col, args.label_col)
    image_index = scan_images(
        data_root, parse_slice_exts(args.slice_ext), args.image_subdir,
        args.relative_paths == "true", data_root.parent)
    manifest, mapping, missing_in_fs, missing_in_csv = align(
        table, name_col, args.id_col, has_id_col, args.label_col,
        image_index, args.drop_name, args.image_subdir)

    write_manifest(out_dir, manifest)
    if mapping is not None:
        write_table(out_dir / "patient_mapping.csv", mapping)

    print(f"Manifest rows: {len(manifest)}")
    if manifest:
        print("Per-label counts:")
        counts: Dict[str, int] = {}
        for row in manifest:
            counts[row["label"]] = counts.get(row["label"], 0) + 1
        for label in sorted(counts):
            print(f"  {label}: {counts[label]} patients")
    if missing_in_fs:
        write_table(out_dir / "missing_in_fs.csv", missing_in_fs)
    if missing_in_csv:
        write_table(out_dir / "missing_in_csv.csv", missing_in_csv)
    print(f"Alignment failures (CSV -> FS missing): {len(missing_in_fs)}")
    print(f"Alignment failures (FS -> CSV missing): {len(missing_in_csv)}")


if __name__ == "__main__":
    main()
