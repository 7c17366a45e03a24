"""The Python client (clients/python) against a live in-process server of
either package, on the CPU: the flows of tests/test_python_client.py, with
the port's server on device="cpu"."""

import os
import sys
import threading

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "clients",
                                "python"))

from syzgy_tpu_client import Document, SyzgyClient, SyzgyException  # noqa: E402


@pytest.fixture(params=["jax", "torch"])
def client(request, tmp_path, monkeypatch):
    if request.param == "jax":
        from syzgydb_tpu.server import config, embedding, rest
        kw = {}
    else:
        from syzgydb_tpu_torch.server import config, embedding, rest
        kw = {"device": "cpu"}
    monkeypatch.setattr(config, "global_config",
                        config.Config(data_folder=str(tmp_path), html_root=""))
    monkeypatch.setattr(embedding, "embed_text",
                        lambda texts, cache: [[0.5, 0.5, 0.5, 0.5]
                                              for _ in texts])
    srv = rest.make_server(str(tmp_path), **kw)
    httpd = rest.make_http_server(srv)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield SyzgyClient(f"http://127.0.0.1:{httpd.server_address[1]}")
    httpd.shutdown()
    for c in srv.collections.values():
        c.close()


def test_client_full_flow(client):
    coll = client.create_collection("demo", vector_size=4, quantization=8,
                                    distance_function="euclidean")
    coll.insert_documents([
        Document(id=1, vector=[0.1, 0.2, 0.3, 0.4], metadata={"t": "a"}),
        Document(id=2, vector=[0.9, 0.8, 0.7, 0.6], metadata={"t": "b"}),
        Document(id=3, text="hello", metadata={"t": "c"}),
    ])
    assert coll.get_document_ids() == [1, 2, 3]

    res = coll.search(vector=[0.1, 0.2, 0.3, 0.4], k=2)
    assert res.results[0].id == 1
    assert res.results[0].metadata == {"t": "a"}
    assert res.percent_searched > 0

    coll.update_document_metadata(1, {"t": "z"})
    res = coll.search(vector=[0.1, 0.2, 0.3, 0.4], k=1)
    assert res.results[0].metadata == {"t": "z"}

    res = coll.search(vector=[0.0] * 4, k=5, filter="t == 'b'")
    assert [r.id for r in res.results] == [2]

    res = coll.search(text="hello", k=1)
    assert res.results[0].id == 3

    coll.delete_document(2)
    assert coll.get_document_ids() == [1, 3]

    infos = client.get_collections()
    assert infos[0].info.name == "demo"
    assert infos[0].info.document_count == 2

    got = client.get_collection("demo")
    assert got.info.quantization == 8
    assert got.info.distance_method == "euclidean"

    client.delete_collection("demo")
    with pytest.raises(SyzgyException):
        client.get_collection("demo")


def test_client_error_surface(client):
    with pytest.raises(SyzgyException) as exc:
        client.get_collection("missing")
    assert "404" in str(exc.value)
