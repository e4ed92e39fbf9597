"""The reader of shard_reduce_calls_per_query: the mesh's stage A calls
that totalled a scanned lane by the reduce and carry kernels, a query;
nothing for a program without the counter, and the metric reported in
the four-card cell alone."""
from portbench import harness


def test_reduce_calls_per_query_reads_the_counter():
    m = harness.metric("shard_reduce_calls_per_query")
    ctx = harness.Readings(setup_s=1.0, queries=["q1", "q2", "q3", "q4",
                                                 "q5", "q6"],
                           launches={"shard_partials": 16,
                                     "shard_reduce": 16})
    assert abs(m.read(ctx) - 16 / 6) < 1e-12
    ctx.launches = {"shard_partials": 16}     # no reduce counter
    assert m.read(ctx) is None


def test_only_the_mesh_cell_reports_the_reduce_calls():
    for w in ("g1_1e7_k100.sortagg", "g1_1e7_k100.wide",
              "taq_10m_20m.asof_window", "g1_1e9_k100.mesh4"):
        names = {m["name"] for m in harness.load_cell(w).per_layer}
        assert ("shard_reduce_calls_per_query" in names) == \
            (w == "g1_1e9_k100.mesh4"), w
