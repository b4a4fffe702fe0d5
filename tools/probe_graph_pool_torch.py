#!/usr/bin/env python3
"""Probe of PyTorch's CUDA graph memory pools, shared by several graphs.

Run on a GPU machine:

    python3 tools/probe_graph_pool_torch.py

What ``parallel/graphs.py`` relies on, each step printed with the bytes
the caching allocator reserves (``torch.cuda.memory_reserved``) and the
segments its snapshot lists for the pool:

  1. three graphs captured into one pool handle (``graph_pool_handle()``):
     a large one, then a smaller one on the same capture stream (the pool
     should not grow: it reuses the first graph's freed blocks), then a
     smaller one on another stream (the allocator keeps blocks by stream, so
     the pool grows);
  2. the graphs replayed in any order, each output cloned before the next
     replay: every clone equals the eager result;
  3. graphs dropped one by one: the pool's segments go back to the card
     (after ``empty_cache()``) only when its last graph is gone;
  4. a capture into a pool that other graphs hold fails (a host sync
     inside it): whether ``capture_end`` stopped routing allocations to the
     pool, what the caller must release, and whether the other graphs and
     a later capture into the pool still work;
  5. a first capture into a fresh handle fails, its use released: whether
     the handle can be captured into again.

Prints one JSON line last.
"""
import gc
import json
import subprocess

MIB = 2 ** 20


def card_line():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_graph_pool_torch: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "card": card_line(), "steps": {}}
    print(f"torch {torch.__version__} cuda {torch.version.cuda} [{report['card']}]")

    def reserved():
        torch.cuda.synchronize()
        return torch.cuda.memory_reserved(dev)

    def pool_segments(handle):
        """Bytes of the snapshot's segments that belong to ``handle``."""
        total, seen = 0, False
        for seg in torch.cuda.memory_snapshot():
            pid = seg.get("segment_pool_id")
            if pid is not None:
                seen = True
                if tuple(pid) == tuple(handle):
                    total += seg["total_size"]
        return total if seen else None

    def make(n_floats):
        def fn(x):
            big = torch.ones(n_floats, device=dev)       # the call's temporary
            return {"y": x * 2 + big[:x.numel()].view_as(x) + big.sum()}
        return fn

    def eager(fn, x):
        return fn(x)["y"].clone()

    def capture(fn, x, handle, stream):
        static = x.clone()
        g = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream())
        before = reserved()
        with torch.cuda.stream(stream):
            g.capture_begin(pool=handle, capture_error_mode="thread_local")
            out = fn(static)
            g.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        return g, static, out, reserved() - before

    def ramp(k):
        return torch.arange(1024, dtype=torch.float32, device=dev) * k

    def reset_generator(state):
        """A failed capture leaves the default generator capturing."""
        fresh = torch.Generator(device=dev)
        fresh.set_state(state)
        torch.cuda.default_generators[0].graphsafe_set_state(fresh)

    x = ramp(1)
    big, small = make(64 * 2 ** 20), make(32 * 2 ** 20)    # 256 and 128 MiB
    for fn in (big, small):
        eager(fn, x)
    gc.collect()
    torch.cuda.empty_cache()
    base = reserved()
    handle = torch.cuda.graph_pool_handle()
    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

    # 1. three captures into one handle
    graphs = {}
    for name, fn, stream in (("big_s1", big, s1), ("small_s1", small, s1),
                             ("small_s2", small, s2)):
        g, static, out, grew = capture(fn, x, handle, stream)
        graphs[name] = (g, static, out, fn)
        del g, static, out
        report["steps"][f"capture_{name}_grew_mib"] = grew / MIB
        print(f"1. capture {name}: the pool grew {grew / MIB:.1f} MiB; "
              f"reserved above base {(reserved() - base) / MIB:.1f} MiB; the "
              f"snapshot's segments of the pool "
              f"{(pool_segments(handle) or 0) / MIB:.1f} MiB")
    report["steps"]["pool_segments_mib"] = (pool_segments(handle) or 0) / MIB
    report["steps"]["snapshot_has_pool_id"] = pool_segments(handle) is not None

    # 2. replays in any order, each output cloned before the next
    ok, k = True, 0
    for order in (["big_s1", "small_s1", "small_s2"], ["small_s2", "big_s1",
                                                      "small_s1", "big_s1"]):
        for name in order:
            g, static, out, fn = graphs[name]
            k += 1
            xi = ramp(k)
            static.copy_(xi)
            g.replay()
            got = out["y"].clone()
            ok &= bool(torch.equal(got, eager(fn, xi)))
            del g, static, out
    report["steps"]["replays_equal_eager"] = ok
    print(f"2. replays in two orders, cloned between: equal to eager {ok}")

    # 3. drop one by one
    freed = {}
    for name in ("big_s1", "small_s1", "small_s2"):
        del graphs[name]
        gc.collect()
        torch.cuda.empty_cache()
        freed[name] = (reserved() - base) / MIB
        print(f"3. dropped {name}: reserved above base {freed[name]:.1f} MiB")
    report["steps"]["reserved_after_drops_mib"] = freed

    # 4. a failed capture into a pool other graphs hold
    handle = torch.cuda.graph_pool_handle()
    held = capture(big, x, handle, s1)
    g = torch.cuda.CUDAGraph()
    s1.wait_stream(torch.cuda.current_stream())
    rng = torch.cuda.default_generators[0].get_state()
    error, stopped = None, None
    notes = []
    with torch.cuda.stream(s1):
        g.capture_begin(pool=handle, capture_error_mode="thread_local")
        try:
            small(x.clone())
            float(x.sum())                                 # a host sync
        except Exception as e:                             # noqa: BLE001
            error = e
            notes.append(f"body: {type(e).__name__}: {str(e)[:160]}")
        try:
            g.capture_end()
            notes.append("capture_end returned")
        except Exception as e:                             # noqa: BLE001
            error = error or e
            notes.append(f"capture_end: {type(e).__name__}: {str(e)[:160]}")
            # stop the routing of allocations to the pool the capture left
            # (a second call shows whether the first found it)
            stopped = 0
            for _ in range(2):
                try:
                    torch._C._cuda_endAllocateToPool(dev.index, handle)
                    stopped += 1
                except RuntimeError as e2:
                    notes.append(f"endAllocateToPool {stopped + 1}: {str(e2)[:120]}")
            torch._C._cuda_releasePool(dev.index, handle)
    torch.cuda.current_stream().wait_stream(s1)
    print("4. " + " | ".join(notes), flush=True)
    report["steps"]["failed_capture_notes"] = notes
    reset_generator(rng)
    del g
    gc.collect()
    report["steps"]["failed_capture_error"] = type(error).__name__ if error else None
    report["steps"]["end_calls_returned"] = stopped
    # does an eager allocation on the capture stream still land in the pool?
    seg0 = pool_segments(handle)
    with torch.cuda.stream(s1):
        probe = torch.empty(16 * 2 ** 20, device=dev)
    routed = pool_segments(handle) - seg0
    del probe
    report["steps"]["eager_alloc_routed_to_pool_mib"] = routed / MIB
    gh, static, out, _ = held
    xi = ramp(7)
    static.copy_(xi)
    gh.replay()
    still = bool(torch.equal(out["y"].clone(), eager(big, xi)))
    try:
        again = capture(small, x, handle, s1)
        xi = ramp(9)
        again[1].copy_(xi)
        again[0].replay()
        later = bool(torch.equal(again[2]["y"].clone(), eager(small, xi)))
    except RuntimeError as e:
        print(f"4. a later capture into the pool: {type(e).__name__}: {e}", flush=True)
        torch.cuda.current_stream().wait_stream(s1)
        again, later = (None, None, None, 0), False
    report["steps"]["held_graph_after_failure_ok"] = still
    report["steps"]["capture_after_failure_ok"] = later
    report["steps"]["capture_after_failure_grew_mib"] = again[3] / MIB
    print(f"4. failed capture ({report['steps']['failed_capture_error']}): "
          f"calls of endAllocateToPool that returned {stopped} of 2; an eager "
          f"64 MiB on the capture stream afterwards added {routed / MIB:.1f} MiB "
          f"to the pool; the held graph replays "
          f"right {still}; a later capture into the pool works {later} (grew "
          f"{again[3] / MIB:.1f} MiB)")
    del gh, static, out
    held = None
    gc.collect()
    torch.cuda.empty_cache()
    report["steps"]["reserved_with_later_graph_mib"] = (reserved() - base) / MIB
    again = None
    gc.collect()
    torch.cuda.empty_cache()
    report["steps"]["reserved_after_all_mib"] = (reserved() - base) / MIB
    print(f"4. reserved above base with only the later graph "
          f"{report['steps']['reserved_with_later_graph_mib']:.1f} MiB, with none "
          f"{report['steps']['reserved_after_all_mib']:.1f} MiB", flush=True)

    # 5. a failed first capture, then the same handle again
    handle = torch.cuda.graph_pool_handle()
    g = torch.cuda.CUDAGraph()
    rng = torch.cuda.default_generators[0].get_state()
    with torch.cuda.stream(s1):
        g.capture_begin(pool=handle, capture_error_mode="thread_local")
        try:
            float(x.sum())
        except Exception:                                  # noqa: BLE001
            pass
        try:
            g.capture_end()
        except Exception:                                  # noqa: BLE001
            try:
                torch._C._cuda_endAllocateToPool(dev.index, handle)
                torch._C._cuda_releasePool(dev.index, handle)
            except RuntimeError:
                pass
    torch.cuda.current_stream().wait_stream(s1)
    reset_generator(rng)
    del g
    gc.collect()
    try:
        reuse = capture(small, x, handle, s1)
        report["steps"]["reuse_released_handle"] = "ok"
        del reuse
    except Exception as e:                                 # noqa: BLE001
        report["steps"]["reuse_released_handle"] = f"{type(e).__name__}: {str(e)[:200]}"
        try:
            torch.cuda.current_stream().wait_stream(s1)
        except Exception:                                  # noqa: BLE001
            pass
    print(f"5. a handle whose only capture failed, captured into again: "
          f"{report['steps']['reuse_released_handle']}")
    report["apis"] = {
        "current_blas_handle": hasattr(torch.cuda, "current_blas_handle"),
        "clearCublasWorkspaces": hasattr(torch._C, "_cuda_clearCublasWorkspaces")}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
