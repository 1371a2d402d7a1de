"""Cells of BENCHMARK.json cut to sizes the CPU runs in seconds: the same
configuration and mix files, with the sizes and pools overridden."""

from milbench import spec

SIZES = {
    "fusion.dispim": ({"raw_zyx": [8, 40, 49], "beads_per_128_cube": 3000, "n_iters": 3},
                      {"pool": 3, "warmup": 1, "check_sample": 2}),
    "reg.dispim": ({"raw_zyx": [8, 40, 49], "beads_per_128_cube": 3000},
                   {"pool": 3, "warmup": 1, "check_sample": 2}),
    "decon.sv512.gauss": ({"shape_zyx": [24, 32, 40], "beads_per_128_cube": 4000},
                          {"pool": 2, "warmup": 1}),
    "decon.sv512.measured": ({"shape_zyx": [24, 32, 40], "beads_per_128_cube": 4000},
                             {"pool": 2, "warmup": 1}),
}
SEED = 2 ** 31 + 12345


def cell(name):
    c = spec.find_cell(name)
    cfg, traffic = SIZES[name]
    c.config = dict(c.config, **cfg)
    c.traffic = dict(c.traffic, **traffic)
    return c
