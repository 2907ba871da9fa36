"""Device time of the operations that are neither an SSD kernel nor a
cuBLAS or CUTLASS product, in percent of all device time: the model's
elementwise and reduction ops, attention's softmax and masking, copies."""
import devtrace


def read(run):
    if run.trace is None:
        return None
    total = run.trace.seconds(lambda n: True)
    if total <= 0:
        return None
    rest = run.trace.seconds(lambda n: not devtrace.is_ssd(n)
                             and not devtrace.is_gemm(n))
    return 100 * rest / total
