"""Each CUDA kernel's ctypes binding against its C entry point, on the CPU.

The kernels are built and launched only on the card, and ctypes does not
see a C signature: a binding with one argument too many or of the wrong
kind fails at the first launch there. This reads each `extern "C"` entry
point from its source under keypointfusion_torch/csrc/ and holds the
binding's argtypes to it (the kernels', K1 'default''s groups-only entry
point's, the info entry points of both K1 kernels, both K2 kernels and
K3), kind
by kind: a pointer or a stream is a c_void_p, a float a c_float, an int a
c_int. The host image decoders (csrc/host/image_decode.cc, bound in
data/image_io.py) are held the same way: they run in the CPU tests, but
a pointer bound as an int is cut to 32 bits only where the buffer lies
above 4 GiB, which a test may never see.
"""

import ctypes
import re

import pytest

from keypointfusion_torch.data.image_io import DECODER
from keypointfusion_torch.kernels import desa_dense as k1
from keypointfusion_torch.kernels import grouped_mlp_pool as k3
from keypointfusion_torch.kernels import pixel_sampler as k2

# name -> (source, C entry point, argtypes)
BINDINGS = {k.name: (k.source, k.symbol, k.argtypes)
            for k in (k1.KERNEL, k1.SERVING_KERNEL, k2.KERNEL,
                      k2.SERVING_KERNEL, k3.KERNEL)}
BINDINGS['desa_dense_serving_groups'] = (
    k1.SERVING_KERNEL.source, 'kpf_desa_dense_serving_groups',
    k1.GROUPS_ARGTYPES)
for _m, _k in ((k1, k1.KERNEL), (k1, k1.SERVING_KERNEL), (k2, k2.KERNEL),
               (k2, k2.SERVING_KERNEL)):
    BINDINGS[_k.name + '_info'] = (_k.source, _k.symbol + '_info',
                                   _m.INFO_ARGTYPES)
BINDINGS[k3.KERNEL.name + '_info'] = (k3.KERNEL.source,
                                      k3.KERNEL.symbol + '_info',
                                      k3.INFO_ARGTYPES)
for _symbol, _argtypes in DECODER.functions.items():
    BINDINGS[_symbol] = (DECODER.source, _symbol, _argtypes)


def c_parameter_kinds(source: str, symbol: str):
    match = re.search(r'extern "C" int ' + symbol + r'\s*\(([^)]*)\)',
                      source)
    assert match, f'{symbol} not found'
    kinds = []
    for param in match.group(1).split(','):
        param = param.strip()
        if '*' in param or param.startswith('cudaStream_t'):
            kinds.append(ctypes.c_void_p)
        elif param.startswith('float'):
            kinds.append(ctypes.c_float)
        elif param.startswith('int'):
            kinds.append(ctypes.c_int)
        else:
            raise AssertionError(f'unknown parameter kind: {param}')
    return kinds


@pytest.mark.parametrize('name', sorted(BINDINGS))
def test_binding_matches_c_entry_point(name):
    source, symbol, argtypes = BINDINGS[name]
    assert list(argtypes) == c_parameter_kinds(source.read_text(), symbol)


def test_every_decoder_entry_point_is_bound():
    """Each `extern "C"` entry point of the host decoders has a binding,
    and the library that g++ builds exports it."""
    text = DECODER.source.read_text()
    assert set(re.findall(r'extern "C" int (\w+)\s*\(', text)) == set(
        DECODER.functions)
    lib = DECODER.load()
    for symbol in DECODER.functions:
        assert getattr(lib, symbol).argtypes == DECODER.functions[symbol]
