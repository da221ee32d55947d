"""Child entry point of :mod:`.exec_in_new_process`: unpickle
``(func, args, kwargs)`` from standard input and call it."""
import pickle
import sys


def main():
    func, args, kwargs = pickle.loads(sys.stdin.buffer.read())
    func(*args, **kwargs)


if __name__ == "__main__":
    main()
