"""Step1 of the port (the manifest step, without pandas) against the JAX
package's step1 (pandas) on the CPU: the same four outputs, byte for byte
(``manifest.jsonl``, ``patient_mapping.csv``, ``missing_in_fs.csv``,
``missing_in_csv.csv``, or the same absence of each), on the pipeline
test's dataset and on variants of it: zh headers, headerless CSVs, a
gbk-encoded CSV, an id column, CSVs with differing columns (NaN in
``meta``), ``--drop_name``, ``--relative_paths false``, ``--label_col``,
missing folders and missing CSV rows, names that match only after
whitespace normalisation, quoting, blank lines, short rows and repeated
headers."""

import shutil
from pathlib import Path

import pytest

from emr2a_tpu.pipelines.step1_manifest import build_manifest as jax_step1
from emr2a_tpu_torch.pipelines.step1_manifest import build_manifest as step1

LABELS = ["Bacterial", "Viral", "PJP", "Normal"]
OUTPUTS = ("manifest.jsonl", "patient_mapping.csv", "missing_in_fs.csv",
           "missing_in_csv.csv")


def _tree(root: Path, folders: dict, csvs: dict, encoding="utf-8") -> Path:
    """data_root with Case_csv/<Label>.csv (text per label) and
    CT_2D_image_core/<Label>/<folder>/slice_{1,2,10}.png (empty files)."""
    data_root = root / "data"
    (data_root / "Case_csv").mkdir(parents=True)
    for label, names in folders.items():
        for name in names:
            pdir = data_root / "CT_2D_image_core" / label / name
            pdir.mkdir(parents=True)
            for s in (10, 2, 1):
                (pdir / f"slice_{s}.png").write_bytes(b"")
            (pdir / "notes.txt").write_bytes(b"")
    for label, text in csvs.items():
        enc = encoding.get(label, "utf-8") if isinstance(encoding, dict) else encoding
        (data_root / "Case_csv" / f"{label}.csv").write_bytes(text.encode(enc))
    return data_root


def _base(root: Path, header="name,sex,age,fever,symptom", n=4) -> Path:
    folders, csvs = {}, {}
    for label in LABELS:
        names = [f"{label.lower()}_patient_{i}" for i in range(n)]
        folders[label] = names
        rows = [header] if header else []
        rows += [f"{name},男,{30 + i},有,咳嗽" for i, name in enumerate(names)]
        csvs[label] = "\n".join(rows) + "\n"
    return _tree(root, folders, csvs)


def _assert_same_outputs(data_root: Path, tmp_path: Path, *extra) -> None:
    ours, theirs = tmp_path / "port_out", tmp_path / "jax_out"
    step1.main(["--data_root", str(data_root), "--out_dir", str(ours), *extra])
    jax_step1.main(["--data_root", str(data_root), "--out_dir", str(theirs), *extra])
    for name in OUTPUTS:
        assert (ours / name).exists() == (theirs / name).exists(), name
        if (theirs / name).exists():
            assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    assert (theirs / "manifest.jsonl").exists()


@pytest.mark.parametrize("extra", [[], ["--relative_paths", "false"],
                                   ["--drop_name"], ["--slice_ext", ""]])
def test_base_dataset(tmp_path, extra):
    _assert_same_outputs(_base(tmp_path), tmp_path, *extra)


def test_zh_headers(tmp_path):
    _assert_same_outputs(_base(tmp_path, header="姓名,性别,年龄,发热,症状"), tmp_path)


def test_zh_headers_with_both_fever_columns(tmp_path):
    """发热 and 发烧 both canonicalise to ``fever``: the later value wins."""
    root = _base(tmp_path, header="姓名,性别,年龄,发热,症状")
    for label in LABELS:
        p = root / "Case_csv" / f"{label}.csv"
        lines = p.read_text(encoding="utf-8").splitlines()
        p.write_text("\n".join([lines[0] + ",发烧"] + [l + ",无" for l in lines[1:]]) + "\n",
                     encoding="utf-8")
    _assert_same_outputs(root, tmp_path)


@pytest.mark.parametrize("n_cols", [5, 3])
def test_headerless_csvs(tmp_path, n_cols):
    folders = {label: [f"{label}_p{i}" for i in range(3)] for label in LABELS}
    csvs = {label: "".join(",".join([f"{label}_p{i}", "女", "40", "无", "发热"][:n_cols]) + "\n"
                           for i in range(3)) for label in LABELS}
    _assert_same_outputs(_tree(tmp_path, folders, csvs), tmp_path)


def test_gbk_encoded_csv(tmp_path):
    folders = {label: ["张三", "李四"] if label == "Viral" else [f"{label}_a"]
               for label in LABELS}
    csvs = {label: "姓名,性别,症状\n" + "".join(f"{n},男,咳嗽、发热\n" for n in names)
            for label, names in folders.items()}
    root = _tree(tmp_path, folders, csvs,
                 encoding={"Viral": "gbk", "PJP": "utf-8-sig", "Normal": "gb18030"})
    _assert_same_outputs(root, tmp_path)


def test_id_column(tmp_path):
    folders = {label: [f"ID{label[0]}{i}" for i in range(2)] + [f"{label}_named"]
               for label in LABELS}
    csvs = {}
    for label in LABELS:
        csvs[label] = ("patient_id,name,age\n"
                       f"ID{label[0]}0,x{label},1\n"         # matched by id
                       f" ID{label[0]}1 ,y{label},2\n"       # id with spaces
                       f",{label}_named,3\n"                  # empty id, by name
                       f"NOPE{label},ghost{label},4\n")       # no folder
    _assert_same_outputs(_tree(tmp_path, folders, csvs), tmp_path)


def test_csvs_with_differing_columns_give_nan_meta(tmp_path):
    folders = {label: [f"{label}_{i}" for i in range(2)] for label in LABELS}
    csvs = {
        "Bacterial": "name,sex,age\nBacterial_0,M,1\nBacterial_1,F,2\n",
        "Viral": "name,age,note,patient_id\nViral_0,3,a,\nViral_1,4,\"b,c\",Viral_1\n",
        "PJP": "sex,name\nM,PJP_0\nF,PJP_1\n",
        "Normal": "name,fever,sex\nNormal_0,yes,M\nNormal_1,no,F\n",
    }
    root = _tree(tmp_path, folders, csvs)
    _assert_same_outputs(root, tmp_path)
    text = (tmp_path / "port_out" / "manifest.jsonl").read_text(encoding="utf-8")
    assert "NaN" in text


def test_label_column(tmp_path):
    folders = {label: [f"{label}_{i}" for i in range(2)] for label in LABELS}
    # every CSV names its rows' class; one row points at another class
    csvs = {label: f"name,class\n{label}_0,{label}\n{label}_1,{LABELS[(i + 1) % 4]}\n"
            for i, label in enumerate(LABELS)}
    _assert_same_outputs(_tree(tmp_path, folders, csvs), tmp_path,
                         "--label_col", "class")


def test_missing_folders_rows_and_normalised_names(tmp_path):
    folders = {"Bacterial": ["Li Ming", "only_folder"], "Viral": ["Wang​Fang"],
               "PJP": ["pjp_1"], "Normal": []}
    csvs = {"Bacterial": "name,symptom\nLiMing,\"cough, fever\"\nghost \"a\",x\n",
            "Viral": "name,symptom\nWangFang,ok\nno_folder,\"line\nbreak\"\n",
            "PJP": "name,symptom\npjp_1,ok\n,empty name\n",
            "Normal": "name,symptom\nlonely,ok\n"}
    _assert_same_outputs(_tree(tmp_path, folders, csvs), tmp_path)
    assert (tmp_path / "port_out" / "missing_in_fs.csv").exists()
    assert (tmp_path / "port_out" / "missing_in_csv.csv").exists()


def test_blank_lines_short_rows_repeated_headers(tmp_path):
    folders = {label: [f"{label}_{i}" for i in range(3)] for label in LABELS}
    csvs = {label: (f"name,,sex,sex\r\n\r\n{label}_0,a,M,x\r\n   \r\n"
                    f"{label}_1,b\r\n{label}_2,,F,\r\n") for label in LABELS}
    _assert_same_outputs(_tree(tmp_path, folders, csvs), tmp_path)


def test_missing_image_category_and_mapping_absent_with_id_col(tmp_path):
    root = _base(tmp_path, header="patient_id,name,sex,age,fever", n=2)
    shutil.rmtree(root / "CT_2D_image_core" / "Normal")
    _assert_same_outputs(root, tmp_path)
    assert not (tmp_path / "port_out" / "patient_mapping.csv").exists()


def test_row_longer_than_header_raises(tmp_path):
    root = _base(tmp_path)
    p = root / "Case_csv" / "PJP.csv"
    p.write_text(p.read_text(encoding="utf-8") + "a,b,c,d,e,f\n", encoding="utf-8")
    with pytest.raises(ValueError):
        step1.main(["--data_root", str(root), "--out_dir", str(tmp_path / "o")])
