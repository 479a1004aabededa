// Golden-vector driver: links the UNMODIFIED reference static library
// (built from /root/reference/device) and drives its encode+encrypt pipeline
// with deterministic seeds, printing every intermediate so the JAX framework
// can be validated bit-for-bit.  This file is new glue code (mirrors the
// calling pattern of the reference's own tests).
//
// Usage: golden_driver sym|asym [n nprimes]

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "ckks_asym.h"
#include "ckks_common.h"
#include "ckks_sym.h"
#include "defines.h"
#include "parameters.h"
#include "sample.h"
#include "util_print.h"

static void fill_seed(uint8_t *seed, uint8_t tag)
{
    for (size_t i = 0; i < SE_PRNG_SEED_BYTE_COUNT; i++) seed[i] = (uint8_t)(tag + i);
}

// print_poly_flpt_full uses SE_PRINT_PREC_STR ("%0.2f"), which does not
// round-trip float32; print values ourselves at 9 significant digits.
static void print_values_full(const char *name, const flpt *v, size_t len)
{
    printf("%s : { ", name);
    for (size_t i = 0; i < len; i++)
        printf("%.9g%s", (double)v[i], (i + 1 < len) ? ", " : " ");
    printf("}\n");
}

static void set_values(size_t testnum, size_t vlen, flpt *v)
{
    // Deterministic test patterns (our own; printed so nothing is implicit).
    for (size_t i = 0; i < vlen; i++)
    {
        switch (testnum)
        {
            case 0: v[i] = 0; break;
            case 1: v[i] = 1; break;
            case 2: v[i] = (flpt)(i % 2); break;
            case 3: v[i] = (flpt)((double)i / (double)vlen); break;
            case 4: v[i] = (flpt)(((int)(i % 7) - 3) * 0.5); break;
            default: v[i] = (flpt)((((i * 2654435761u) >> 16) & 0xFF) * 0.01 - 1.0); break;
        }
    }
}

int main(int argc, char **argv)
{
    int asym = (argc > 1 && strcmp(argv[1], "asym") == 0);
    size_t n = (argc > 2) ? (size_t)atoi(argv[2]) : 4096;
    size_t nprimes = (argc > 3) ? (size_t)atoi(argv[3]) : 3;
    size_t ntests = (argc > 4) ? (size_t)atoi(argv[4]) : 6;

    Parms parms;
    parms.sample_s = true;
    parms.is_asymmetric = asym ? true : false;
    parms.small_s = true;
    parms.small_u = true;
    parms.pk_from_file = false;

    ZZ *mempool = asym ? ckks_mempool_setup_asym(n) : ckks_mempool_setup_sym(n);
    SE_PTRS se_ptrs;
    if (asym)
        ckks_set_ptrs_asym(n, mempool, &se_ptrs);
    else
        ckks_set_ptrs_sym(n, mempool, &se_ptrs);

    // Separate buffers so nothing aliases (the pool aliases ntt_pte with c1).
    ZZ *c0 = calloc(n, sizeof(ZZ));
    ZZ *c1 = calloc(n, sizeof(ZZ));
    ZZ *ntt_pte = calloc(n, sizeof(ZZ));
    ZZ *ntt_roots = calloc(4 * n, sizeof(ZZ));
    ZZ *s = calloc(n, sizeof(ZZ));
    ZZ *u = calloc(n, sizeof(ZZ));
    int8_t *e1 = calloc(n, sizeof(int8_t));
    flpt *v = calloc(n / 2, sizeof(flpt));
    ZZ *pk0 = calloc(n * nprimes, sizeof(ZZ));
    ZZ *pk1 = calloc(n * nprimes, sizeof(ZZ));
    int8_t *ep = calloc(n, sizeof(int8_t));
    ZZ *dummy = calloc(n, sizeof(ZZ));

    uint8_t sk_seed[SE_PRNG_SEED_BYTE_COUNT];
    uint8_t share_seed[SE_PRNG_SEED_BYTE_COUNT];
    uint8_t err_seed[SE_PRNG_SEED_BYTE_COUNT];
    uint8_t pk_seed[SE_PRNG_SEED_BYTE_COUNT];
    uint8_t pkep_seed[SE_PRNG_SEED_BYTE_COUNT];
    fill_seed(sk_seed, 1);
    fill_seed(share_seed, 2);
    fill_seed(err_seed, 3);
    fill_seed(pk_seed, 4);
    fill_seed(pkep_seed, 5);

    SE_PRNG prng;
    SE_PRNG shareable_prng;

    ckks_setup(n, nprimes, se_ptrs.index_map_ptr, &parms);

    // Secret key: sampled deterministically from sk_seed.
    ckks_setup_s(&parms, sk_seed, &prng, s);
    print_poly_uint8_full("sk_packed", (uint8_t *)s, n / 4);

    if (asym)
    {
        // Device-side pk generation with deterministic seeds, all primes.
        SE_PRNG ep_prng;
        prng_randomize_reset(&ep_prng, pkep_seed);
        sample_poly_cbd_generic_prng_16(n, &ep_prng, ep);
        print_poly_int8_full("pk_ep", ep, n);
        prng_randomize_reset(&shareable_prng, pk_seed);
        // pk gen is a symmetric encrypt of zero; walk the chain in sym mode
        // (ckks_next_prime_sym asserts !is_asymmetric).
        parms.is_asymmetric = false;
        for (size_t i = 0; i < parms.nprimes; i++)
        {
            ckks_encode_encrypt_sym(&parms, 0, ep, &shareable_prng, s, ntt_pte, ntt_roots,
                                    &pk0[i * n], &pk1[i * n], dummy, dummy);
            print_poly_full("pk0", &pk0[i * n], n);
            print_poly_full("pk1", &pk1[i * n], n);
            if (i + 1 < parms.nprimes) ckks_next_prime_sym(&parms, s);
        }
        parms.is_asymmetric = true;
        ckks_reset_primes(&parms);
    }

    for (size_t testnum = 0; testnum < ntests; testnum++)
    {
        ckks_reset_primes(&parms);
        set_values(testnum, n / 2, v);
        print_values_full("v", v, n / 2);

        bool ret = ckks_encode_base(&parms, v, n / 2, se_ptrs.index_map_ptr, se_ptrs.ifft_roots,
                                    se_ptrs.conj_vals);
        se_assert(ret);
        print_poly_int64_full("pt", se_ptrs.conj_vals_int_ptr, n);

        if (asym)
        {
            /* NOTE: err_seed is deliberately REUSED for every test so the
             * golden vectors are deterministic per message pattern.  This
             * makes u/e0/e1 identical across the tests under one pk, which
             * leaks plaintext differences — fine for an oracle, never a
             * usage example. */
            ckks_asym_init(&parms, err_seed, &prng, se_ptrs.conj_vals_int_ptr, u, e1);
            print_poly_int64_full("pte", se_ptrs.conj_vals_int_ptr, n);
            print_poly_uint8_full("u_packed", (uint8_t *)u, n / 4);
            print_poly_int8_full("e1", e1, n);
            for (size_t i = 0; i < parms.nprimes; i++)
            {
                memcpy(c0, &pk0[i * n], n * sizeof(ZZ));
                memcpy(c1, &pk1[i * n], n * sizeof(ZZ));
                ckks_encode_encrypt_asym(&parms, se_ptrs.conj_vals_int_ptr, u, e1, ntt_roots,
                                         ntt_pte, NULL, NULL, c0, c1);
                print_poly_full("c0", c0, n);
                print_poly_full("c1", c1, n);
                if (i + 1 < parms.nprimes) ckks_next_prime_asym(&parms, u);
            }
        }
        else
        {
            ckks_sym_init(&parms, share_seed, err_seed, &shareable_prng, &prng,
                          se_ptrs.conj_vals_int_ptr);
            print_poly_int64_full("pte", se_ptrs.conj_vals_int_ptr, n);
            for (size_t i = 0; i < parms.nprimes; i++)
            {
                ZZ *c1_save = calloc(n, sizeof(ZZ));
                ckks_encode_encrypt_sym(&parms, se_ptrs.conj_vals_int_ptr, NULL, &shareable_prng,
                                        s, ntt_pte, ntt_roots, c0, c1, NULL, c1_save);
                print_poly_full("c0", c0, n);
                print_poly_full("c1", c1_save, n);
                free(c1_save);
                if (i + 1 < parms.nprimes) ckks_next_prime_sym(&parms, s);
            }
        }
    }
    printf("golden driver done\n");
    return 0;
}
