"""The port's session conf surface against the JAX package's session.

``TpuSession.builder.config(...).getOrCreate()``, ``session.conf``
(``RuntimeConf``: ``set``, ``get``, ``unset``, ``snapshot``), the
catalog (``registerTable``, ``table``) and ``stop``: each behaviour is
run on both packages' sessions with the same keys and tables, and the
observable outcomes (values read back, snapshots' parsed values, what
raises, the rows of a query over a registered table) are equal.
"""

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import conf as JC
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.column import col as jcol
from spark_rapids_tpu.sql.session import TpuSession as JaxSession

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.column import col
from spark_rapids_tpu_torch.sql.session import (
    RuntimeConf, TpuSession, TpuSessionBuilder)

CPU = {"spark.rapids.sql.enabled": False}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(conf=None):
    return TpuSession(conf, device="cpu")


def _table(shift=0):
    return pa.table({"k": [i % 4 for i in range(32)],
                     "v": [float(i + shift) for i in range(32)]})


def _rows(t):
    return sorted(map(repr, t.to_pylist()))


def test_builder_config_and_get_or_create():
    """``builder`` is a fresh builder at each access; ``config`` takes a
    key and value or a dict, the last value of a key wins, and
    ``getOrCreate`` builds a session over the collected conf."""
    conf = {"spark.rapids.tpu.batchRows": 2048}
    sessions = []
    for cls, kw in ((TpuSession, {"device": "cpu"}), (JaxSession, {})):
        b1, b2 = cls.builder, cls.builder
        assert b1 is not b2
        b = (b1.config("spark.rapids.sql.enabled", False)
             .config(conf=conf)
             .config("spark.rapids.tpu.batchRows", 4096))
        if kw:
            b = b.config(**kw)
        s = b.getOrCreate()
        assert isinstance(s, cls)
        sessions.append(s)
    port, jax = sessions
    assert isinstance(TpuSession.builder, TpuSessionBuilder)
    assert port.device == torch.device("cpu")
    for key in ("spark.rapids.sql.enabled", "spark.rapids.tpu.batchRows"):
        assert port.conf.get(key) == jax.conf.get(key)
    assert (port.rapids_conf().batch_rows
            == jax.rapids_conf().batch_rows == 4096)
    assert port.rapids_conf().sql_enabled is jax.rapids_conf().sql_enabled \
        is False


def test_runtime_conf_set_get_unset_snapshot():
    port, jax = _port(CPU), JaxSession(dict(CPU))
    assert isinstance(port.conf, RuntimeConf)
    for s in (port, jax):
        assert s.conf.get("spark.rapids.tpu.batchRows") is None
        assert s.conf.get("spark.rapids.tpu.batchRows", 7) == 7
        s.conf.set("spark.rapids.tpu.batchRows", "8192")
        assert s.conf.get("spark.rapids.tpu.batchRows") == "8192"
    # snapshots parse the raw values alike
    assert (port.conf.snapshot().get(C.BATCH_ROWS)
            == jax.conf.snapshot().get(JC.BATCH_ROWS) == 8192)
    assert port.rapids_conf().get(C.BATCH_ROWS) == 8192
    for s in (port, jax):
        s.conf.unset("spark.rapids.tpu.batchRows")
        s.conf.unset("spark.rapids.tpu.never.set")  # no error
    assert (port.conf.snapshot().get(C.BATCH_ROWS)
            == jax.conf.snapshot().get(JC.BATCH_ROWS))
    # a bad value is stored raw and refused when the snapshot parses it
    outcomes = []
    for s in (port, jax):
        s.conf.set("spark.rapids.tpu.batchRows", "lots")
        with pytest.raises(ValueError) as e:
            s.conf.snapshot()
        outcomes.append("batchRows" in str(e.value))
        s.conf.unset("spark.rapids.tpu.batchRows")
    assert outcomes[0] == outcomes[1]


def test_runtime_conf_set_reaches_the_next_query():
    """A key set on a live session plans the next query: the fusion
    plane turned on by ``conf.set`` builds a region."""
    port = _port()
    t = _table()

    def q(s, c=col):
        return (s.createDataFrame(t).filter(c("k") > 0)
                .select((c("v") * 2).alias("w")))

    df = q(port)
    df.toArrow()
    assert "FusedStage" not in df._last_plan.tree_string()
    port.conf.set("spark.rapids.tpu.fusion.enabled", True)
    df2 = q(port)
    got = df2.toArrow()
    assert "FusedStage" in df2._last_plan.tree_string()
    assert _rows(got) == _rows(q(JaxSession(dict(CPU)), jcol).toArrow())


def test_unknown_key_raises_at_creation_in_both():
    for make in (lambda c: _port(c), lambda c: JaxSession(c)):
        with pytest.raises(ValueError, match="unknown"):
            make({"spark.rapids.tpu.no.such.key": 1})


def test_register_table_and_table():
    """``registerTable`` returns a DataFrame over the catalog table,
    ``table`` reads it back by name (its relation carries the content
    fingerprint and the name), a re-registration re-binds the name, and
    an unknown name raises ``KeyError`` in both packages."""
    port, jax = _port(), JaxSession(dict(CPU))
    outs = []
    for s, c, Fm in ((port, col, F), (jax, jcol, JF)):
        df = s.registerTable("t", _table())
        assert _rows(df.toArrow()) == _rows(_table())
        q = s.table("t").groupBy("k").agg(Fm.sum("v").alias("sv"))
        first = q.toArrow()
        s.registerTable("t", _table(shift=100))
        second = s.table("t").groupBy("k").agg(
            Fm.sum("v").alias("sv")).toArrow()
        assert _rows(first) != _rows(second)
        rel = s.table("t")._plan
        assert rel.source == "t" and rel.fingerprint.startswith("t")
        with pytest.raises(KeyError):
            s.table("nope")
        outs.append((_rows(first), _rows(second), rel.fingerprint))
    assert outs[0] == outs[1]


def test_stop_is_a_no_op():
    for s in (_port(), JaxSession(dict(CPU))):
        assert s.stop() is None
        assert s.stop() is None
        # the session still runs queries after stop, as in the JAX package
        assert s.createDataFrame(_table()).count() == 32
