"""The cases of ``test_torch_conv_nd.py`` and
``test_torch_conv_nd_3d.py``: the N-d convolution and pooling ops of the
port against the JAX package's through ``torch_op_parity``, within 1e-5
relative and absolute on the forward and the gradient."""
import numpy as np

from torch_op_parity import Case, rng_for, uniform

F5 = dict(rtol=1e-5, atol=1e-5, grad_rtol=1e-5, grad_atol=1e-5)
SPATIAL = {1: (9,), 2: (7, 6), 3: (5, 6, 4)}
LAYOUTS = {1: ("NCW", "NWC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


def last(x):
    """A channels-first array in its channel-last layout."""
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


def conv_nd_cases(ranks):
    """Every op and attribute case at each of ``ranks`` (1, 2, 3) in both
    layouts, with ``im2col`` / ``col2im`` at the same ranks."""
    c = []
    for n in ranks:
        sp = SPATIAL[n]
        for layout in LAYOUTS[n]:
            r = rng_for(f"conv_nd/{layout}")
            lay = last if layout == LAYOUTS[n][1] else (lambda a: a)
            x = uniform(r, (2, 4) + sp)
            ones = (1,) * n
            # convolution: weight (O, I/g, *k) -> (O, *k, I/g) when last
            w = uniform(r, (6, 2) + (3,) * n)
            c.append(Case("Convolution", [lay(x), lay(w), uniform(r, (6,))],
                          {"kernel": (3,) * n, "stride": (2,) + ones[1:],
                           "pad": ones, "dilate": (2,) * n, "num_filter": 6,
                           "num_group": 2, "layout": layout},
                          tag=f"{layout}-group-dilate", **F5))
            c.append(Case("Convolution", [lay(x), lay(uniform(r, (3, 4)
                                                               + ones))],
                          {"kernel": ones, "num_filter": 3, "no_bias": True,
                           "layout": layout}, tag=f"{layout}-1x1", **F5))
            # deconvolution: weight (I, O/g, *k) -> (I, *k, O/g) when last
            wd = uniform(r, (4, 3) + (3,) * n)
            c.append(Case("Deconvolution", [lay(x), lay(wd),
                                            uniform(r, (6,))],
                          {"kernel": (3,) * n, "stride": (2,) * n,
                           "pad": ones, "adj": ones, "num_filter": 6,
                           "num_group": 2, "no_bias": False,
                           "layout": layout},
                          tag=f"{layout}-adj-group", **F5))
            pool = dict(kernel=(3,) * n, stride=(2,) * n, layout=layout)
            for tag, attrs in (
                    ("max", dict(pool_type="max")),
                    ("max-pad", dict(pool_type="max", pad=ones)),
                    ("avg", dict(pool_type="avg", pad=ones)),
                    ("avg-nopad", dict(pool_type="avg", pad=ones,
                                       count_include_pad=False)),
                    ("sum", dict(pool_type="sum", pad=ones)),
                    ("max-full", dict(pool_type="max",
                                      pooling_convention="full")),
                    ("avg-full", dict(pool_type="avg", pad=ones,
                                      pooling_convention="full",
                                      count_include_pad=False))):
                c.append(Case("Pooling", [lay(x)], dict(pool, **attrs),
                              tag=f"{layout}-{tag}", **F5))
            # lp: p 1 over data with exact zeros (|x|'s gradient there)
            xz = x * (r.rand(*x.shape) > 0.3)
            c.append(Case("Pooling", [lay(xz)],
                          dict(pool, pool_type="lp", p_value=1, pad=ones,
                               pooling_convention="full"),
                          tag=f"{layout}-lp1-zeros", **F5))
            xp = uniform(r, x.shape, 0.5, 1.5) * np.sign(x)
            c.append(Case("Pooling", [lay(xp)],
                          dict(pool, pool_type="lp", p_value=2),
                          tag=f"{layout}-lp2", **F5))
            for ptype in ("avg", "max", "lp"):
                c.append(Case("Pooling", [lay(xp)],
                              {"kernel": ones, "pool_type": ptype,
                               "global_pool": True, "layout": layout},
                              tag=f"{layout}-global-{ptype}", **F5))
        # im2col / col2im take channels-first data at every rank
        r = rng_for(f"im2col/{n}")
        x = uniform(r, (2, 3) + sp)
        kern = (3,) + (2,) * (n - 1)
        c.append(Case("im2col", [x], {"kernel": kern, "stride": (2,) * n,
                                      "pad": (1,) * n,
                                      "dilate": (1,) * (n - 1) + (2,)},
                      tag=f"{n}d", **F5))
        o = [(s + 2 - (k - 1) - 1) // 1 + 1 for s, k in zip(sp, kern)]
        cols = uniform(r, (2, 3 * int(np.prod(kern)), int(np.prod(o))))
        c.append(Case("col2im", [cols], {"output_size": sp, "kernel": kern,
                                         "pad": (1,) * n}, tag=f"{n}d",
                      **F5))
    return c


