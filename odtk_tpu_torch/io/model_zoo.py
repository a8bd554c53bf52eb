"""ImageNet-pretrained backbone weights: fetch-with-cache and the default
init of a fresh model.

A copy of ``odtk_tpu/io/model_zoo.py``. The original ODTK loads the
torchvision model-zoo weights into every fresh backbone
(odtk/backbones/resnet.py:21-22, mobilenet.py:16-17), and its default
recipe (lr 0.01) assumes that init. ``init_pretrained(model)`` maps each
backbone to its torchvision file, looks for it in the directories torch
hub caches into (so weights that torchvision fetched before are found
without a download), downloads it with a bounded timeout when it is
absent, and warns loudly, once, when it cannot be had: a machine without
network trains from scratch knowingly.

Cache resolution order:
  1. $ODTK_WEIGHTS_DIR (if set)
  2. $TORCH_HOME/hub/checkpoints (torch's own zoo cache)
  3. ~/.cache/torch/hub/checkpoints (when TORCH_HOME is unset)
A download lands in the first writable directory of that list, through
a temporary file named for the process and an atomic rename, so ranks
that fetch side by side never write one file.
"""

import os
import sys

# torchvision model-zoo URLs, the exact set the original loads
# (torchvision.models.resnet.model_urls / mobilenet as of v0.8, the
# version ODTK pins). Keys are the registry's names; C4 variants share
# the FPN weights (same trunk).
ZOO_URLS = {
    'ResNet18FPN':
        'https://download.pytorch.org/models/resnet18-5c106cde.pth',
    'ResNet34FPN':
        'https://download.pytorch.org/models/resnet34-333f7ec4.pth',
    'ResNet50FPN':
        'https://download.pytorch.org/models/resnet50-19c8e357.pth',
    'ResNet101FPN':
        'https://download.pytorch.org/models/resnet101-5d3b4d8f.pth',
    'ResNet152FPN':
        'https://download.pytorch.org/models/resnet152-b121ed2d.pth',
    'ResNeXt50_32x4dFPN':
        'https://download.pytorch.org/models/resnext50_32x4d-7cdf4587.pth',
    'ResNeXt101_32x8dFPN':
        'https://download.pytorch.org/models/resnext101_32x8d-8ba56ff5.pth',
    'MobileNetV2FPN':
        'https://download.pytorch.org/models/mobilenet_v2-b0353104.pth',
    'ResNet18C4':
        'https://download.pytorch.org/models/resnet18-5c106cde.pth',
    'ResNet34C4':
        'https://download.pytorch.org/models/resnet34-333f7ec4.pth',
}

_WARNED = set()
_OFFLINE = [False]   # the first failed download short-circuits later ones


def _cache_dirs():
    dirs = []
    if os.environ.get('ODTK_WEIGHTS_DIR'):
        dirs.append(os.environ['ODTK_WEIGHTS_DIR'])
    torch_home = os.environ.get(
        'TORCH_HOME', os.path.join(os.path.expanduser('~'), '.cache',
                                   'torch'))
    dirs.append(os.path.join(torch_home, 'hub', 'checkpoints'))
    return dirs


def _warn(msg):
    if msg not in _WARNED:
        _WARNED.add(msg)
        print(f'WARNING: {msg}', file=sys.stderr, flush=True)


def part_path(directory, fname):
    """The temporary file a download writes before its rename: one per
    process, so that ranks fetching the same file never share one."""
    return os.path.join(directory, f'{fname}.{os.getpid()}.part')


def fetch(backbone_name, timeout=20.0):
    """Path to the pretrained .pth for a backbone, or None.

    Cache hit -> path immediately. Miss -> bounded-timeout download
    into the cache (atomic rename). Unreachable network -> one loud
    warning, None, and no further attempts in this process."""
    url = ZOO_URLS.get(backbone_name)
    if url is None:
        _warn(f'no ImageNet weights known for backbone {backbone_name!r}; '
              f'training it from scratch')
        return None
    fname = url.rsplit('/', 1)[-1]
    for d in _cache_dirs():
        p = os.path.join(d, fname)
        if os.path.isfile(p):
            return p
    if _OFFLINE[0]:
        return None
    for d in _cache_dirs():
        try:
            os.makedirs(d, exist_ok=True)
        except OSError:
            continue
        tmp = part_path(d, fname)
        try:
            import urllib.request
            with urllib.request.urlopen(url, timeout=timeout) as r, \
                    open(tmp, 'wb') as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            out = os.path.join(d, fname)
            os.replace(tmp, out)
            return out
        except Exception as e:  # noqa: BLE001 — offline is expected
            try:
                os.remove(tmp)
            except OSError:
                pass
            _OFFLINE[0] = True
            _warn(f'could not download ImageNet weights for '
                  f'{backbone_name} ({type(e).__name__}: {str(e)[:80]}). '
                  f'Training FROM SCRATCH — the default recipe (lr 0.01) '
                  f'assumes pretrained init; provide the file via '
                  f'--backbone-weights or $ODTK_WEIGHTS_DIR, or lower '
                  f'the learning rate.')
            return None
    return None


def init_pretrained(model, verbose=True):
    """Load ImageNet weights into every backbone of a fresh model (the
    original's default init), through ``torch_import.
    load_backbone_weights``. Returns the list of backbones actually
    initialized."""
    from .torch_import import load_backbone_weights

    done = []
    for bb in model.backbones:
        path = fetch(bb)
        if path is None:
            continue
        if verbose:
            print(f'Initializing {bb} from ImageNet weights ({path})')
        load_backbone_weights(model, bb, path)
        done.append(bb)
    return done
