"""Shared CLI plumbing: hand-rolled flag loops mirroring the reference's
argv conventions (e.g. reference:src/reg3D.cpp:90-160) and checked stack
reads."""

from __future__ import annotations

import os
import sys


class FlagParser:
    """strcmp-style flag loop. Flags either consume one value or are bare
    toggles; unknown flags print a warning like the reference apps."""

    def __init__(self, argv):
        self.argv = list(argv)
        self.values = {}
        self.present = set()

    def parse(self, value_flags, bare_flags=()):
        i = 0
        while i < len(self.argv):
            a = self.argv[i]
            if a in value_flags:
                if i + 1 >= len(self.argv):
                    print(f"*** Flag {a} requires a value")
                    sys.exit(1)
                self.values[a] = self.argv[i + 1]
                self.present.add(a)
                i += 2
            elif a in bare_flags:
                self.present.add(a)
                i += 1
            else:
                print(f"*** Unknown option: {a}")
                sys.exit(1)
        return self

    def get(self, flag, default=None, cast=str):
        if flag in self.values:
            return cast(self.values[flag])
        return default

    def has(self, flag):
        return flag in self.present


def ensure_exists(path, what="image"):
    if not os.path.isfile(path):
        print(f"*** Failed to read {what}!!! File does not exist: {path}")
        sys.exit(1)


def read_stack_checked(path, what="image"):
    from microimagelib_tpu_torch.io.tiff import readtifstack

    ensure_exists(path, what)
    return readtifstack(path)


def tifinfo_checked(path, what="image"):
    from microimagelib_tpu_torch.io.tiff import gettifinfo

    ensure_exists(path, what)
    return gettifinfo(path)
