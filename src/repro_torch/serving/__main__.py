"""``python -m repro_torch.serving <command>`` — currently: smoke (mirror
of ``repro/serving/__main__.py``)."""
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m repro_torch.serving smoke [options]")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "smoke":
        from repro_torch.serving.smoke import main as smoke_main
        return smoke_main(rest)
    print(f"unknown command {cmd!r} (want: smoke)", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
