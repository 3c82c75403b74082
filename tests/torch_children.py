"""Child processes that a port test module starts as it begins.

Some parity checks need jax's x64 mode from process start, or a process of
their own, and run in a child.  A module starts its children when its first
test starts, so that they run beside the module's other tests, and a test
waits for the child whose output it reads.  Output goes to temporary files,
never to a pipe that could fill while nobody reads it.
"""
import os
import subprocess
import sys
import tempfile

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


class Child:
    """One child ``python -c code *args`` with jax on the CPU, one OpenMP
    thread and ``src`` on its path; x64 mode unless ``x64`` is false."""

    def __init__(self, code, *args, x64=True, env=None):
        env = dict(os.environ if env is None else env, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
        if x64:
            env["JAX_ENABLE_X64"] = "1"
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        self._out = tempfile.TemporaryFile("w+")
        self._err = tempfile.TemporaryFile("w+")
        self._proc = subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                                      stdout=self._out, stderr=self._err, text=True)
        self._done = None

    def result(self, timeout):
        """Wait for the child (killed after ``timeout`` seconds) and return
        its ``subprocess.CompletedProcess``."""
        if self._done is None:
            try:
                self._proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.stop()
                raise
            self._out.seek(0)
            self._err.seek(0)
            self._done = subprocess.CompletedProcess(self._proc.args, self._proc.returncode,
                                                     self._out.read(), self._err.read())
        return self._done

    def stop(self):
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self._out.close()
        self._err.close()
