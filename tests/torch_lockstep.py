"""Runs a test of the JAX package's against both packages in lockstep, for
the parity files of the repair, choreo, tower and leader modules
(tests/test_torch_repair.py, test_torch_choreo_detectors.py,
test_torch_tower_send.py, test_torch_leaders.py).

`lockstep(fn, names)` runs the reference's test function `fn` twice: once
with its globals bound to the JAX package's classes and functions, once to
the port's (`names` maps each global to a module path below the package
root, "repair.forest.Forest", or a module, "choreo.voter"). Both
runs record every method call on an
instance of a bound class and every call of a bound function, with its
arguments and its result, and, at the end, every such instance's whole
state; the two records must be equal, and the reference's own asserts
run on both. Results and state are compared by value: dataclasses by
their fields, package objects by their attributes (a cycle stops at its
first repeat), sets as sets; any other object by its type's name."""
import dataclasses
import importlib
import random
import types

ROOTS = ("firedancer_tpu", "firedancer_tpu_torch")


def seeded_urandom(seed: int):
    """A seeded stand-in for os.urandom (n -> n bytes): patched into
    `os` before each package's run, it gives both the same draws."""
    return random.Random(seed).randbytes


def _resolve(root: str, path: str):
    try:
        return importlib.import_module(f"{root}.{path}")
    except ModuleNotFoundError:
        mod, _, attr = path.rpartition(".")
        return getattr(importlib.import_module(f"{root}.{mod}"), attr)


def norm(x, seen=None):
    seen = set() if seen is None else seen
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, type):
        return ("type", x.__name__)
    if isinstance(x, dict):
        return ("dict", sorted(((repr(norm(k, seen)), norm(v, seen))
                                for k, v in x.items()), key=lambda kv: kv[0]))
    if isinstance(x, (set, frozenset)):
        return ("set", sorted(repr(norm(i, seen)) for i in x))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__ if type(x) in (list, tuple) else "seq",
                [norm(i, seen) for i in x])
    if hasattr(x, "__iter__") and type(x).__name__ in ("deque",
                                                       "OrderedDict"):
        return norm(list(x.items()) if hasattr(x, "items") else list(x),
                    seen)
    mod = type(x).__module__ or ""
    if not mod.split(".")[0] in ROOTS:
        return ("obj", type(x).__name__)
    if id(x) in seen:
        return ("cycle", type(x).__name__)
    seen = seen | {id(x)}
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, [norm(getattr(x, f.name), seen)
                                   for f in dataclasses.fields(x)])
    state = getattr(x, "__dict__", None)
    if state is None:
        return ("obj", type(x).__name__)
    return (type(x).__name__, norm({k: v for k, v in state.items()
                                    if not callable(v)}, seen))


def _recording_class(cls, log, made):
    def init(self, *a, **k):
        cls.__init__(self, *a, **k)
        made.append(self)

    body = {"__init__": init, "__qualname__": cls.__qualname__,
            "__module__": cls.__module__}
    for name, attr in vars(cls).items():
        if name.startswith("__") or not isinstance(attr, types.FunctionType):
            continue

        def method(self, *a, _f=attr, _n=name, **k):
            out = _f(self, *a, **k)
            log.append((cls.__name__, _n, norm(a), norm(k), norm(out)))
            return out
        body[name] = method
    return type(cls.__name__, (cls,), body)


def _recording_function(fn, log):
    def call(*a, **k):
        try:
            out = fn(*a, **k)
        except Exception as e:
            log.append((fn.__name__, norm(a), norm(k), "raises",
                        type(e).__name__, str(e)))
            raise
        log.append((fn.__name__, norm(a), norm(k), norm(out)))
        return out
    return call


def run_on(fn, names: dict, root: str, *args, **kw):
    """`fn` with its globals in `names` bound to package `root`'s, each
    recording. -> (the record, fn's result)."""
    log, made = [], []
    g = dict(fn.__globals__)
    for gname, path in names.items():
        obj = _resolve(root, path)
        if isinstance(obj, type) and not issubclass(obj, BaseException):
            g[gname] = _recording_class(obj, log, made)
        elif isinstance(obj, types.FunctionType):
            g[gname] = _recording_function(obj, log)
        elif isinstance(obj, types.ModuleType):
            # a module's own functions record; its constants, classes
            # and exceptions are the package's
            g[gname] = types.SimpleNamespace(**{
                k: (_recording_function(v, log)
                    if isinstance(v, types.FunctionType)
                    and v.__module__ == obj.__name__ else v)
                for k, v in vars(obj).items() if not k.startswith("__")})
        else:
            g[gname] = obj
    bound = types.FunctionType(fn.__code__, g, fn.__name__,
                               fn.__defaults__, fn.__closure__)
    out = bound(*args, **kw)
    return log + [("state", norm(m)) for m in made], out


def lockstep(fn, names: dict, *args, **kw):
    """Run `fn` on both packages; assert equal records. -> the record."""
    ref, _ = run_on(fn, names, ROOTS[0], *args, **kw)
    port, _ = run_on(fn, names, ROOTS[1], *args, **kw)
    assert len(port) == len(ref), (len(port), len(ref))
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"call {i}: reference {a!r} != port {b!r}"
    return ref
