"""repro_torch's rank rendezvous (``launch/mesh.py::spawn``), CPU, gloo.

``spawn`` used to pick a TCP port by binding port 0 and closing the
socket, then hand the number to its ranks, whose rank 0 bound it again
later: between the two another process could take the port, and a rank
failed with ``EADDRINUSE``. The ranks now meet through a ``file://``
store in a temporary directory that ``spawn`` creates and removes; gloo
binds its own sockets and publishes them through the store. Twenty
two-rank gloo worlds, started back to back in four concurrent chains
of five (so the rendezvous of several worlds overlap in time), each an
all-reduce: every world succeeds, its ranks see a ``file://`` ``init_method`` and
nothing else, and every rendezvous directory is gone afterwards.
"""
import os
import threading
import urllib.parse

import torch

from repro_torch.launch import mesh as mesh_mod

WORLDS, CHAINS = 20, 4


def sum_rank(rank, world, init_method):
    """One all-reduce over the world: 1 + 2 on two ranks."""
    torch.set_num_threads(1)
    mesh = mesh_mod.init((world, 1), ("data", "model"), rank, init_method,
                         "cpu")
    try:
        x = mesh.world.all_reduce(torch.tensor([rank + 1.0]))
        return init_method, float(x[0])
    finally:
        mesh_mod.destroy(mesh)


def test_back_to_back_worlds_meet_through_a_file_store():
    results, errors = [], []

    def chain(n):
        try:
            for _ in range(n):
                results.append(mesh_mod.spawn(sum_rank, 2, (),
                                              timeout_s=300))
        except BaseException as e:       # reported by the test thread
            errors.append(e)

    threads = [threading.Thread(target=chain, args=(WORLDS // CHAINS,))
               for _ in range(CHAINS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        assert not t.is_alive()
    assert not errors, errors
    assert len(results) == WORLDS
    methods = set()
    for ranks in results:
        (m0, s0), (m1, s1) = ranks
        assert m0 == m1 and s0 == s1 == 3.0
        methods.add(m0)
    assert len(methods) == WORLDS                 # one store a world
    for m in methods:
        url = urllib.parse.urlparse(m)
        assert url.scheme == "file", m            # no tcp:// port probe
        assert not os.path.exists(os.path.dirname(url.path)), m
    assert not hasattr(mesh_mod, "free_port")
