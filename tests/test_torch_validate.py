"""Raw-table validation through the port (``fairmultimodal_torch/data/validate.py``):
the cases of ``tests/test_validate.py``, each error naming the file and the
column with the JAX package's message, and ``count_unmapped`` on arrays.
The cohort-table check is ``data/featurize.py``'s (``test_torch_*``
featurize tests)."""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pandas as pd
import pytest

from fairmultimodal_tpu.data import validate as j_validate
from fairmultimodal_tpu.data.synthetic import write_raw_mimic
from fairmultimodal_torch.data.etl import run_etl
from fairmultimodal_torch.data.validate import (REQUIRED_RAW_COLUMNS, MimicInputError,
                                                count_unmapped, validate_mimic_dir)


@pytest.fixture()
def raw_dir(tmp_path):
    d = tmp_path / "raw"
    write_raw_mimic(str(d), n_subjects=10, seed=0)
    return d


def _messages(path):
    """(JAX message, port message) of validating ``path``."""
    out = []
    for fn, err in ((j_validate.validate_mimic_dir, j_validate.MimicInputError),
                    (validate_mimic_dir, MimicInputError)):
        with pytest.raises(err) as e:
            fn(str(path))
        out.append(str(e.value))
    return out


def test_required_columns_are_the_jax_tables():
    assert REQUIRED_RAW_COLUMNS == j_validate.REQUIRED_RAW_COLUMNS
    assert issubclass(MimicInputError, ValueError)


def test_valid_dir_passes(raw_dir):
    validate_mimic_dir(str(raw_dir))


def test_missing_required_table_named(raw_dir):
    os.remove(raw_dir / "ADMISSIONS.csv.gz")
    want, got = _messages(raw_dir)
    assert got == want and "ADMISSIONS.csv.gz: required table is missing" in got


def test_missing_optional_table_ok(raw_dir):
    os.remove(raw_dir / "LABEVENTS.csv.gz")
    validate_mimic_dir(str(raw_dir))


def test_missing_column_named(raw_dir):
    df = pd.read_csv(raw_dir / "ICUSTAYS.csv.gz")
    df.drop(columns=["INTIME"]).to_csv(raw_dir / "ICUSTAYS.csv.gz", index=False,
                                       compression="gzip")
    want, got = _messages(raw_dir)
    assert got == want
    assert "ICUSTAYS.csv.gz: missing column(s) INTIME (found: HADM_ID, ICUSTAY_ID" in got


@pytest.mark.parametrize("content", [b"this is not gzip data", b""])
def test_corrupt_or_empty_gzip_named(raw_dir, content):
    with open(raw_dir / "PATIENTS.csv.gz", "wb") as f:
        f.write(content)
    with pytest.raises(MimicInputError, match="PATIENTS.csv.gz"):
        validate_mimic_dir(str(raw_dir))


def test_not_a_directory():
    with pytest.raises(MimicInputError, match="not a directory"):
        validate_mimic_dir("/nonexistent/raw_mimic")


def test_run_etl_fails_fast_on_bad_dir(tmp_path):
    d = tmp_path / "raw"
    write_raw_mimic(str(d), n_subjects=8, seed=1)
    os.remove(d / "NOTEEVENTS.csv.gz")
    with pytest.raises(MimicInputError, match="NOTEEVENTS.csv.gz"):
        run_etl(str(d), str(tmp_path / "out"), device="cpu")
    assert not (tmp_path / "out" / "final_structured_dataset.csv").exists()


def test_count_unmapped():
    raw = np.array(["WHITE", "KLINGON", "OTHER", "MARTIAN", None, " other "], dtype=object)
    mapped = np.array(["White", "Other", "Other", "Other", "Other", "Other"], dtype=object)
    # KLINGON, MARTIAN and the missing cell fell through; the literal OTHERs did not.
    assert count_unmapped(raw, mapped, "Other") == 3
    assert count_unmapped(raw, mapped, "Other") == j_validate.count_unmapped(
        pd.Series(raw), pd.Series(mapped), "Other")


def test_etl_reports_unmapped_categories(tmp_path):
    d = tmp_path / "raw"
    write_raw_mimic(str(d), n_subjects=12, seed=4)
    adm = pd.read_csv(d / "ADMISSIONS.csv.gz")
    adm.loc[adm.index[:5], "ETHNICITY"] = "UNSEEN CATEGORY X"
    adm.to_csv(d / "ADMISSIONS.csv.gz", index=False, compression="gzip")
    with redirect_stdout(io.StringIO()) as out:
        run_etl(str(d), str(tmp_path / "out"), device="cpu")
    assert "unmapped ETHNICITY routed to 'Other'" in out.getvalue()
