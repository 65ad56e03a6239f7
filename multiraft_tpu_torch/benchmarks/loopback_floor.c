/* Raw loopback TCP ping-pong floor for this host: two threads, one
 * byte-exchange per round trip, no Python, no codec — the kernel
 * syscall + scheduler-wake cost that ANY userspace RPC on this box
 * must pay per serial round trip.  The native transport's µs/RPC is
 * judged against this floor:
 * whatever the echo bench measures above it is the framework's own
 * overhead (codec + dispatch + future resolution).
 *
 * The PyTorch port's own copy of benchmarks/loopback_floor.c.
 * Build/run (multiraft_tpu_torch/benchmarks/transport_echo.py's
 * bench_floor() builds it into build/torch_native/; manual form):
 *   cc -O2 -o loopback_floor loopback_floor.c -lpthread
 *   ./loopback_floor [rounds]   ->  one line: min/median µs per RTT
 */
#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

static int g_port = 0;
static int g_rounds = 20000;

static double now_us(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec * 1e6 + ts.tv_nsec / 1e3;
}

static void *server_main(void *arg) {
    int lfd = socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    struct sockaddr_in a = {0};
    a.sin_family = AF_INET;
    a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    a.sin_port = 0;
    bind(lfd, (struct sockaddr *)&a, sizeof a);
    socklen_t alen = sizeof a;
    getsockname(lfd, (struct sockaddr *)&a, &alen);
    g_port = ntohs(a.sin_port);
    listen(lfd, 1);
    __sync_synchronize();
    int fd = accept(lfd, NULL, NULL);
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    char buf[64];
    for (;;) {
        ssize_t r = read(fd, buf, sizeof buf);
        if (r <= 0) break;
        if (write(fd, buf, r) != r) break;
    }
    close(fd);
    close(lfd);
    return NULL;
}

static int cmp_d(const void *x, const void *y) {
    double a = *(const double *)x, b = *(const double *)y;
    return (a > b) - (a < b);
}

int main(int argc, char **argv) {
    if (argc > 1) g_rounds = atoi(argv[1]);
    pthread_t th;
    pthread_create(&th, NULL, server_main, NULL);
    while (!g_port) usleep(1000);
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    struct sockaddr_in a = {0};
    a.sin_family = AF_INET;
    a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    a.sin_port = htons(g_port);
    if (connect(fd, (struct sockaddr *)&a, sizeof a) != 0) {
        perror("connect");
        return 1;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    char buf[64] = "x";
    /* Warm-up. */
    for (int i = 0; i < 2000; i++) {
        if (write(fd, buf, 16) != 16 || read(fd, buf, sizeof buf) <= 0)
            return 1;
    }
    /* 5 batches, same shape as the echo bench: min + median. */
    enum { BATCHES = 5 };
    double us[BATCHES];
    int per = g_rounds / BATCHES;
    for (int b = 0; b < BATCHES; b++) {
        double t0 = now_us();
        for (int i = 0; i < per; i++) {
            if (write(fd, buf, 16) != 16) return 1;
            if (read(fd, buf, sizeof buf) <= 0) return 1;
        }
        us[b] = (now_us() - t0) / per;
    }
    qsort(us, BATCHES, sizeof us[0], cmp_d);
    printf("{\"path\": \"loopback_floor_c\", \"n\": %d, "
           "\"us_per_rtt\": %.2f, \"us_per_rtt_median\": %.2f}\n",
           g_rounds, us[0], us[BATCHES / 2]);
    close(fd);
    return 0;
}
