"""tpuar command-line driver.

Same verbs, flags, and defaults as the reference CLI (jiahansu/GPUAR
src/main.cpp:85-96): ``tpuar c|d --in=F --out=G [--host] [--device=N]``.
Compress is the default mode when ``d`` is absent (src/main.cpp:102); the
default output name is ``output.gip`` (:130).  ``--host`` selects the native
serial backend; otherwise the batched device backend runs on all local GPUs
(``--device`` pins one).  Without a GPU the device path refuses to start
(unless JAX_PLATFORMS=cpu selects the CPU on purpose); it never falls back
to the host codec by itself.
"""

from __future__ import annotations

import argparse
import sys

from gpuar_tpu.utils.stats import ProgressMonitor


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpuar",
        description="Block-parallel adaptive arithmetic coder for GPUs",
    )
    p.add_argument("mode", nargs="?", default="c", choices=["c", "d", "v"],
                   help="c: compress (default), d: decompress, v: verify "
                        "archive integrity (extension; no output written)")
    p.add_argument("--in", dest="input", required=True, help="input file")
    p.add_argument("--out", dest="output", default="output.gip",
                   help="output file (default output.gip)")
    p.add_argument("--host", action="store_true",
                   help="run the codec on the host CPU (native golden path)")
    p.add_argument("--device", type=int, default=None,
                   help="pin one GPU by index; default: all local GPUs "
                        "(with --multihost: the card this process takes, "
                        "default its process id)")
    p.add_argument("--batch-packets", type=int, default=None,
                   help="packets per super-batch (bounds memory)")
    p.add_argument("--threads", type=int, default=1,
                   help="host-codec worker threads (--host, and v --deep; "
                        "0 = all cores).  Packets are "
                        "independent, so any value yields an identical "
                        "archive/verdict")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process mode: every process codes its file "
                        "range on one card and splices at gathered offsets "
                        "(shared filesystem)")
    p.add_argument("--coordinator", default=None,
                   help="with --multihost: coordinator host:port (default "
                        "$JAX_COORDINATOR_ADDRESS)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="with --multihost: number of processes")
    p.add_argument("--process-id", type=int, default=None,
                   help="with --multihost: this process's id")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted compression: complete "
                        "packets already in the output are kept")
    p.add_argument("--debug", action="store_true",
                   help="decompress with the kernel's debug checks: coder "
                        "invariants + bitstream-overrun detection per "
                        "packet (reference -D_DEBUG parity); corrupt "
                        "packets raise instead of decoding garbage")
    p.add_argument("--deep", action="store_true",
                   help="with v: also decode every packet on the host "
                        "codec and flag bitstream overruns (detects "
                        "corrupt well-framed packets)")
    p.add_argument("--nointeractive", action="store_true",
                   help="suppress progress output")
    p.add_argument("--json", action="store_true",
                   help="print stats as one JSON line")
    return p


def make_compressor(args):
    kwargs = {}
    if args.batch_packets:
        kwargs["super_batch_packets"] = args.batch_packets
    if getattr(args, "debug", False):
        kwargs["debug"] = True
    if args.host:
        from gpuar_tpu.pipeline import HostCompressor
        return HostCompressor(threads=args.threads, **kwargs)
    device = args.device
    if args.multihost:
        from gpuar_tpu.parallel import distributed
        try:
            distributed.initialize(args.coordinator, args.num_processes,
                                   args.process_id, local_device_id=device)
        except Exception as e:  # the CLI boundary: report and stop
            raise SystemExit(
                f"Error: --multihost could not start jax.distributed "
                f"({e}); give --coordinator, --num-processes and "
                f"--process-id") from e
        device = None  # the process already sees only its own card
    from gpuar_tpu.parallel.runner import NoGPUError, TPUCompressor
    try:
        backend = TPUCompressor(device_index=device, **kwargs)
    except (NoGPUError, ValueError) as e:
        raise SystemExit(f"Error: {e}") from e
    if args.multihost:
        from gpuar_tpu.parallel import distributed
        return distributed.DistributedCompressor(backend=backend)
    return backend


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    # Silent flag interactions would let a user believe a multi-process or
    # resumable run happened when it did not: reject them up front.
    if args.host and args.multihost:
        parser.error("--host and --multihost are mutually exclusive")
    if args.resume and args.mode == "d":
        parser.error("--resume only applies to compression (mode 'c')")
    if args.debug and args.mode != "d":
        parser.error("--debug only applies to decompression (mode 'd')")
    if args.debug and args.host:
        parser.error("--debug requires the device decode path "
                     "(drop --host)")
    if args.deep and args.mode != "v":
        parser.error("--deep only applies to verification (mode 'v')")

    if args.mode == "v":
        import json as _json

        from gpuar_tpu.pipeline import verify_archive
        from gpuar_tpu.utils.stats import SplitTimer

        try:
            with SplitTimer() as t:
                result = verify_archive(args.input, deep=args.deep,
                                        threads=args.threads)
        except (OSError, ValueError) as e:
            print(str(e), file=sys.stderr)
            return 1
        result["seconds"] = round(t.total, 6)
        if args.json:
            print(_json.dumps(result))
        else:
            print(f"{args.input}: OK — {result['packets']} packets, "
                  f"{result['uncompressed_size']} bytes raw, "
                  f"{result['compressed_size']} bytes compressed"
                  f"{' (deep decode verified)' if args.deep else ''}")
        return 0

    monitor = ProgressMonitor(enabled=not args.nointeractive and not args.json)
    compressor = make_compressor(args)

    try:
        if args.mode == "c":
            if not args.json:
                print(f"Start to compress {args.input} to {args.output}.")
            info = compressor.compress(args.input, args.output, monitor,
                                       resume=args.resume)
        else:
            if not args.json:
                print(f"Start to decompress {args.input} to {args.output}.")
            info = compressor.decompress(args.input, args.output, monitor)
    except (OSError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 1

    if args.json:
        print(info.to_json())
        return 0

    print("Complete\n")
    print("Statistics:")
    print(f"Uncompressed file size {info.uncompressed_file_size} bytes")
    print(f"Compressed file size  {info.compressed_file_size} bytes")
    print(f"Compression ratio     {info.ratio:.6g}")
    print(f"Compute time          {info.process_time:.6g} s")
    print(f"I/O time              {info.io_time:.6g} s")
    print(f"Throughput            {info.throughput_gbps:.6g} GB/s")
    print(f"Score                 {info.score:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
